"""Inputs for the cheapest-offering kernel, made with numpy from seeds.

The CPU tests feed them to the JAX package and to the port; the card tests
and ``chip_smoke.py`` feed them to the CUDA kernel and to its plain
version. Every side therefore sees the same shapes and the same data. A
case is ``(tmask [B,T] bool or uint8, zcmask [B,ZC] bool, price [T,ZC]
f32)``, with +inf where an offering is unavailable.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np

Case = Tuple[np.ndarray, np.ndarray, np.ndarray]

# (B, T, ZC): each T of {1, 15, 16, 17, 759} and each ZC of {1, 32, 33, 65}
# at least once, and odd B with odd T, so that no row after the first
# starts on a 16-byte boundary. ZC=32 is the widest register cell mask,
# 33 and 65 take the kernel's shared-memory words.
EDGE_SHAPES = ((3, 1, 1), (17, 1, 32), (31, 15, 33), (40, 16, 65),
               (33, 17, 32), (129, 759, 1), (65, 759, 33))

# the largest bin bucket of the solver (solver/solve.py _B_BUCKETS[-1])
DENSE_B = 8192


def random_case(rng: np.random.Generator, B: int, T: int, ZC: int,
                p_t: float = 0.4, p_zc: float = 0.6,
                p_unavail: float = 0.2) -> Case:
    tm = rng.random((B, T)) < p_t
    zc = rng.random((B, ZC)) < p_zc
    pr = (rng.random((T, ZC)) + 0.01).astype(np.float32)
    pr[rng.random((T, ZC)) < p_unavail] = np.inf
    return tm, zc, pr


def edge_case(B: int, T: int, ZC: int) -> Case:
    """A random case of one edge shape, seeded by the shape."""
    return random_case(np.random.default_rng(B * 10007 + T * 101 + ZC), B, T, ZC)


def sparse_case(rng: np.random.Generator, B: int, T: int = 759,
                ZC: int = 10) -> Case:
    """Shaped like the main path's inputs on the real catalog: each live
    bin allows 2-3 types and a few cells; the last tenth of the bins are
    empty, as unopened bin slots are; bin 1 allows only the last flat
    index ``(T-1)*ZC + ZC-1``."""
    tm = np.zeros((B, T), bool)
    zc = rng.random((B, ZC)) < 0.3
    for b in range(B):
        tm[b, rng.choice(T, size=int(rng.integers(2, 4)), replace=False)] = True
    dead = B - B // 10
    tm[dead:] = False
    zc[dead:] = False
    pr = (rng.random((T, ZC)) + 0.01).astype(np.float32)
    pr[rng.random((T, ZC)) < 0.2] = np.inf
    if B > 1:
        tm[1] = False
        tm[1, T - 1] = True
        zc[1] = False
        zc[1, ZC - 1] = True
        pr[T - 1, ZC - 1] = np.float32(0.5)
    return tm, zc, pr


def dense_case(B: int = DENSE_B, T: int = 759, ZC: int = 10) -> Case:
    """The largest bin bucket at the real catalog's width, 40 % of types
    and 60 % of cells allowed per bin."""
    return random_case(np.random.default_rng(8192), B, T, ZC)


# the batched probe's largest dispatch: the solver's top probe bucket
# (solver/solve.py Solver._K_BUCKETS[-1]) of bin tables of 1,024 rows
PROBE_K, PROBE_B = 32, 1024


def probe_case(K: int = PROBE_K, B: int = PROBE_B, T: int = 759,
               ZC: int = 10) -> Case:
    """K probes' bin tables flattened into one K·B-row call against ONE
    shared price panel, as the batched probe's finalization makes it
    (ops/binpack.py pack_probe_fused): each probe's rows are a sparse
    case, the price is the first probe's."""
    rng = np.random.default_rng(K * 100003 + B)
    parts = [sparse_case(rng, B, T, ZC) for _ in range(K)]
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]), parts[0][2])


def _ties() -> Case:
    tm, zc, _ = random_case(np.random.default_rng(3), 512, 759, 10)
    return tm, zc, np.full((759, 10), 2.5, np.float32)


def _coarse_ties() -> Case:
    tm, zc, pr = random_case(np.random.default_rng(4), 2048, 759, 10)
    return tm, zc, (np.floor(pr * 4) / 4).astype(np.float32)


def _infeasible(prices_inf: bool) -> Case:
    tm, zc, pr = random_case(np.random.default_rng(5), 256, 759, 10)
    tm[:64] = False                    # no type allowed
    zc[64:128] = False                 # no zone x capacity-type allowed
    if prices_inf:
        pr = np.full_like(pr, np.inf)  # nothing available
    return tm, zc, pr


def _signed_zeros() -> Case:
    """Prices of -1.5, -0.0, +0.0 and 0.5: the two zeros compare equal, so
    a tie between them goes to the lower index."""
    rng = np.random.default_rng(9)
    tm, zc, pr = random_case(rng, 300, 759, 10)
    vals = np.array([-1.5, -0.0, 0.0, 0.5], np.float32)
    pr = np.where(np.isfinite(pr), vals[rng.integers(0, 4, pr.shape)], pr)
    pr[rng.random(pr.shape) < 0.9] = np.inf   # few -1.5s, many zero ties
    return tm, zc, pr.astype(np.float32)


def _uint8_masks() -> Case:
    rng = np.random.default_rng(6)
    tm, zc, pr = random_case(rng, 101, 759, 10)
    vals = np.array([1, 2, 128, 255], np.uint8)
    tm8 = np.where(tm, vals[rng.integers(0, 4, tm.shape)], 0).astype(np.uint8)
    return tm8, zc, pr


def kernel_cases() -> Dict[str, Callable[[], Case]]:
    """Every case the kernel is held to against its plain version on the
    card, by name, each made only when called."""
    cases: Dict[str, Callable[[], Case]] = {
        "random B=2048 T=759 ZC=10":
            lambda: random_case(np.random.default_rng(0), 2048, 759, 10),
        "ragged T=37 ZC=10":
            lambda: random_case(np.random.default_rng(1), 300, 37, 10),
        "ZC=130": lambda: random_case(np.random.default_rng(2), 129, 200, 130),
        "ties": _ties,
        "coarse-price ties": _coarse_ties,
        "all-infeasible (masks)": lambda: _infeasible(False),
        "all-infeasible (prices)": lambda: _infeasible(True),
        "long row T=6000": lambda: random_case(np.random.default_rng(7),
                                               64, 6000, 10),
        "uint8 masks": _uint8_masks,
        "signed zeros": _signed_zeros,
        "sparse B=257 T=759 ZC=10":
            lambda: sparse_case(np.random.default_rng(257), 257),
        "sparse B=2047 T=759 ZC=10":
            lambda: sparse_case(np.random.default_rng(2047), 2047),
        "dense B=8192 T=759 ZC=10": dense_case,
        "one offering B=1 T=1 ZC=1": lambda: random_case(
            np.random.default_rng(1), 1, 1, 1, p_t=1.0, p_zc=1.0, p_unavail=0.0),
    }
    for B, T, ZC in EDGE_SHAPES:
        cases[f"edge B={B} T={T} ZC={ZC}"] = (
            lambda B=B, T=T, ZC=ZC: edge_case(B, T, ZC))
    return cases
