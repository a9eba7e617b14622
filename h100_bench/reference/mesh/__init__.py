"""Part of the frozen plain reference (see ``h100_bench/reference/__init__.py``)."""
