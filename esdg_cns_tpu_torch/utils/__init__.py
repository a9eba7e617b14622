"""Diagnostics."""
