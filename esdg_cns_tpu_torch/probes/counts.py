"""The pricing model of the port's kernels: operations per element of each
kernel by kind, the data-sheet bound and the bound priced at the costs the
probes measure.

``Ops`` counts operations by kind (``KINDS``); ``ops_k1``, ``ops_k2``,
``ops_project``, ``ops_lines``, ``ops_k3``, ``ops_dense_2d``, ``ops_face``,
``ops_visc`` and ``ops_k4`` give one element's count of each kernel from
the shapes and operators it is given.  ``bound`` takes a launch's bytes and
operations to the data-sheet floor (the larger of bytes over the HBM peak
and operations over the dtype's peak); ``priced_bound`` prices the f32
operations at the FMA-issue-slot costs of ``probes.transcendental`` and the
FMA rate of ``probes.peak``.  ``h100_bench/roofline.py`` keeps a frozen copy
of these counts for the benchmark.  Nothing here needs a card.
"""

import collections

# the card's published peaks (H100 SXM data sheet): HBM bytes/s, and
# operations/s outside the tensor cores in float32 and float64
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FP64_OPS_PER_S = 34e12


# Operations per element, counted by hand from the sources at the shapes
# they are given, by kind (Ops).  The data-sheet bound weighs an FMA two
# operations and every other kind one (so the bound is a floor); an
# operator product over the operator's entries that the function needs
# (entries(op)): all of them on the tri, one node line per point on the
# Gauss-collocated hex (N+1 of each row of Ef, of each column of LIFT, of
# each row of a derivative); each two-point flux pair counted ONCE (the
# triangular form, the least work).  Each pointwise count (split) keeps
# its hand total in that weighing, with the divisions, logs, exps, powers
# and square roots the source does and the FMAs and multiplies it shows;
# add takes the rest of the total.
# Pair costs: the 3D EC pair with one metric direction (diag) 74, five
# of them divisions (ec_pair_n: the two logarithmic means' v, rho's mean,
# beta's reciprocal mean, the pressure average; the two series terms
# v / 448 are multiplies by 1/448, common.cuh); the
# general 3-term contraction adds the two other directional fluxes (12)
# and two more metric terms per field (20): 106; a curved metric adds the
# pairwise average of the three terms (6): 112.  The 2D EC pair with both
# directions, the metric contraction and both rows' accumulation 85; a
# curved metric adds the average of the four operator-metric terms (8).
# The 1D pair (two logarithmic means, one direction, one metric term, both
# rows' accumulation) 55.
KINDS = ("fma", "mul", "add", "div", "log", "exp", "sqrt", "rsqrt", "pow")


class Ops(dict):
    """Operation counts by kind (KINDS); + adds, * scales by an integer."""

    def __init__(self, **counts):
        unknown = set(counts) - set(KINDS)
        if unknown:
            raise ValueError(f"unknown operation kinds {sorted(unknown)}")
        super().__init__({k: counts.get(k, 0) for k in KINDS})

    def __add__(self, other):
        return Ops(**{k: self[k] + other[k] for k in KINDS})

    def __mul__(self, n):
        return Ops(**{k: self[k] * n for k in KINDS})

    __rmul__ = __mul__

    def flops(self):
        """The data-sheet count: an FMA two operations, any other one."""
        return sum(self.values()) + self["fma"]


def split(total, fma=0, mul=0, **special):
    """A hand total by kind: the special functions and FMAs given, then
    the multiplies given as far as the total allows, add the rest."""
    rest = total - 2 * fma - sum(special.values())
    if rest < 0:
        raise ValueError(f"the kinds exceed the hand total {total}")
    mul = min(mul, rest)
    return Ops(fma=fma, mul=mul, add=rest - mul, **special)


PAIR_3D = {"diag": split(74, fma=11, mul=29, div=5),
           "general": split(106, fma=23, mul=37, div=5),
           "curved": split(112, fma=23, mul=40, div=5)}
PAIR_MODAL = {1: split(55, fma=15, mul=16, div=5),
              2: split(85, fma=29, mul=22, div=5),
              3: PAIR_3D["general"]}
PAIR_TRI_CURVED = split(93, fma=29, mul=26, div=5)
# pow is libdevice's expansion, exp(y log x) with corrections: priced as a
# log, an exp and a multiply
POW_PARTS = ("log", "exp", "mul")


Bound = collections.namedtuple("Bound", "ms by n_bytes ops dtype")


def bound(n_bytes, ops, dtype):
    """The data-sheet floor: the larger of bytes over the HBM peak and
    operations (FMA two, every other kind one) over the peak of the dtype
    (FP32_OPS_PER_S or FP64_OPS_PER_S).  Keeps what priced_bound needs."""
    name = str(dtype).replace("torch.", "")
    if name not in ("float32", "float64"):
        raise ValueError(f"bound: dtype {dtype}")
    peak = FP64_OPS_PER_S if name == "float64" else FP32_OPS_PER_S
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops.flops() / peak * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return Bound(max(t_bytes, t_ops), by, n_bytes, ops, name)


def priced_ms(ops, slots, fma_per_s):
    """The operations' time at the card's measured costs: sum of n_kind
    slots_kind over the FMA rate (FMA/s); an FMA is one slot, pow a log,
    an exp and a multiply."""
    price = dict(slots, fma=1.0)
    price["pow"] = sum(price[k] for k in POW_PARTS)
    return sum(n * price[k] for k, n in ops.items() if n) / fma_per_s * 1e3


def priced_bound(b, slots, fma_per_s):
    """The larger of the bytes leg and the priced operation time; None
    for float64 (the probes are f32, as the TPU ones are)."""
    if b.dtype != "float32":
        return None
    return max(b.n_bytes / HBM_BYTES_PER_S * 1e3,
               priced_ms(b.ops, slots, fma_per_s))


def line_pairs(n1):
    """Pairs of the line loop per element: the triangular vol-vol pairs of
    each line and its two vol-face couplings, over 3 directions."""
    return 3 * n1 * n1 * (n1 * (n1 - 1) // 2 + 2 * n1)


def entries(op):
    """Entries of an operator that its product needs: those above its
    roundoff (1e-12 of its largest).  The hex line operators hold exact
    zeros only up to roundoff of the 1D interpolation."""
    a = op.abs()
    return int((a > 1e-12 * a.max()).sum())


def ops_project(n1, ef_entries):
    """The entropy projection of K1 and row 3: v(U) at the volume nodes
    (ten divisions, three logs), Ef v, and U(v_f) with the flux variables
    and logs at the face points (two pows, an exp, eight divisions, two
    logs)."""
    nq, nfq = n1 ** 3, 6 * n1 * n1
    return (split(27, fma=3, mul=9, div=10, log=3) * nq
            + Ops(fma=ef_entries * 5)
            + split(40, fma=4, mul=12, div=8, log=2, exp=1, pow=2) * nfq)


def ops_k1(n1, ef_entries, lift_entries, form="diag"):
    """K1: the projection, the pairs at the form's cost, the face rows'
    1/wf, LIFT over each point's lines and 2 (1/wq) acc + 2 LIFT."""
    nq, nfq = n1 ** 3, 6 * n1 * n1
    return (ops_project(n1, ef_entries) + PAIR_3D[form] * line_pairs(n1)
            + Ops(mul=5) * nfq + Ops(fma=lift_entries * 5)
            + split(15, fma=5, mul=6) * nq)


def ops_k2(n1, lift_entries, diag=True, split_form=False):
    """At every face node the EC pair (five divisions, as PAIR_3D's),
    both sides' conservative states, both wave speeds (three divisions
    and a square root each) and LF; the general form adds the two other
    directional fluxes (12), two more normal terms per field (20) and the
    3-component normal velocity of both sides (8), and reads 1/sj where
    diag divides.  The split form
    adds the combine: 2 (1/wf) face rows at each face node, and at each
    volume node 2 (1/wq) times the three parts' sum where ph_qf was
    read."""
    nq, nfq = n1 ** 3, 6 * n1 * n1
    face = (split(120, fma=22, mul=52, div=14, sqrt=2) if diag
            else split(160, fma=38, mul=60, div=13, sqrt=2))
    if split_form:
        face = face + Ops(fma=5, mul=1)
    node = split(26, fma=5, mul=6) if split_form else split(15, mul=5)
    return face * nfq + Ops(fma=lift_entries * 5) + node * nq


def ops_lines(n1, curved):
    """Row 10: the line loop alone (general contraction) on given flux
    variables, and the doubling of 2 QF."""
    nh = n1 ** 3 + 6 * n1 * n1
    return (PAIR_3D["curved" if curved else "general"] * line_pairs(n1)
            + Ops(mul=5) * nh)


def tri_pairs(nq, nh):
    return nq * (nq - 1) // 2 + nq * (nh - nq)


def needed_pairs(q_skew, nq):
    """The pairs i < j of K3's sum that the data needs: those with an
    operator entry of any direction above roundoff (1e-12 of the largest),
    the zero face-face block left out.  Every pair on the tri and the line;
    on the collocated hex only the pairs of a node line."""
    a = q_skew.abs()
    nz = (a > 1e-12 * a.max()).any(0)
    nz[nq:, nq:] = False
    return int(nz.triu(1).sum())


def ops_k3(dim, vq, vhp, ph, q_skew, nq, curved=False):
    """K3 per element: the three operator products over the entries they
    need (Vq, Vh Pq and Ph: each full on lines and tris, the identity and
    one node line per face point on the collocated hex), v(U) (3 + dim
    divisions, two logs) and U(v) (4 + dim divisions, two pows, an exp,
    two logs) with the flux variables and logs at each point, and the
    pairs the data needs at the dim's pair cost (curved tris: 93)."""
    nf, nh = dim + 2, vhp.shape[0]
    np_ = ph.shape[0]
    pair = PAIR_TRI_CURVED if curved else PAIR_MODAL[dim]
    return (Ops(fma=nf * (entries(vq) + entries(vhp) + entries(ph)))
            + split(10 + 5 * dim, fma=dim, mul=5 + dim, div=3 + dim,
                    log=2) * nq
            + split(30 + 5 * dim, fma=2 * dim - 2, mul=11, div=4 + dim,
                    log=2, exp=1, pow=2) * nh
            + pair * needed_pairs(q_skew, nq) + Ops(mul=nf) * np_)


def ops_dense_2d(nq, nh, curved):
    """K5 in 2D: K3's pair cost on the triangular pair count, and the
    doubling of 2 QF."""
    pair = PAIR_TRI_CURVED if curved else PAIR_MODAL[2]
    return pair * tri_pairs(nq, nh) + Ops(mul=4) * nh


def line_metric_bytes(n1, k, itemsize):
    """The curved metric values the line loop needs: rows 3d..3d+2 at the
    N+1 volume points and the two face points of each line (864 of the
    1440 per element at N=3)."""
    return 3 * n1 * n1 * 3 * (n1 + 2) * k * itemsize


def ops_face(dim, rebuild_local):
    """One face node of the CNS surface stage: the traces rebuilt (the
    neighbour's conservative (one division) and entropy ones, with
    rebuild_local the local ones too), the BC ghosts and ghost logs, the
    EC pair (five divisions, as PAIR_3D's) and its dim directions
    contracted with the normal, LF (two wave speeds: two divisions and a
    square root each), the entropy BC, the jump and the penalty rows (two
    divisions)."""
    nf = dim + 2
    cons = split(3 * dim + 4, fma=dim, mul=dim + 4, div=1)
    evars = split(3 * dim + 7, fma=dim + 1, mul=dim + 3)
    rebuild = (cons + evars) * (2 if rebuild_local else 1)
    ghosts = split(7 * dim + 2, fma=2 * dim - 1, log=2)
    pair = split(34 + 4 * dim + dim * (2 * dim + 2 + 2 * nf),
                 fma=7 + 2 * dim + (dim - 1) * nf, mul=2, div=5)
    lf = split(4 * dim + 19 + 3 * nf, fma=2 * (dim - 1) + nf, div=4,
               sqrt=2)
    return (rebuild + ghosts + pair + lf + Ops(add=nf)
            + split(4 * dim + 6, div=2) + Ops(add=nf))


def ops_visc(dim, nq, nfq, front, vqlift, ef, drpq):
    """One element of the viscous mid-section, each contraction formed
    once (the kernels repeat some per node; the bound counts what the
    function needs): the front product; the surface gradient term
    (0.5·dv·nxj once per face node, then its lift); per quadrature node
    the gradients, K(v) (83 operations in 2D, 190 in 3D; two divisions)
    and the production; the contracted traction; the divergence (g_r =
    Σ_x geo[r,x]·σ_x once per node, then the D_r Pq products).  front,
    vqlift, ef and drpq are the operators the kernels take."""
    nf = dim + 2
    sigma = {1: 20, 2: 83, 3: 190}[dim]
    front = Ops(fma=entries(front) * nf)
    surface = (Ops(fma=dim * entries(vqlift) * nf)
               + Ops(mul=nfq * nf * (1 + dim)))
    node = (Ops(fma=nf * dim * (dim - 1), mul=2 * nf * dim, add=nf * dim)
            + split(sigma, div=2) + split(3 * dim * nf, fma=dim * nf))
    traction = Ops(fma=dim * nf * entries(ef) + nfq * dim * nf)
    div = (Ops(fma=dim * (dim - 1) * nf * nq, mul=dim * nf * nq)
           + Ops(fma=entries(drpq) * nf))
    return front + surface + node * nq + traction + div


def ops_k4(dim, np_, nq, nfq, k4args, lift):
    """The tail-folded form (merged_tail), as the cavity paths run it;
    k4args are K4's positional arguments (the operators are the last
    four), lift the tail's LIFT."""
    fold = (Ops(fma=2 * (dim + 2) * entries(lift))
            + Ops(add=6 * (dim + 2) * np_))
    return (ops_face(dim, True) * nfq
            + ops_visc(dim, nq, nfq, *k4args[-4:]) + fold)
