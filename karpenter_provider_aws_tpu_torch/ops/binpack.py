"""Grouped-FFD bin-packing scan in PyTorch.

The port of the JAX package's ``ops/binpack.py``: the same grouped
first-fit-decreasing scan over G signature groups, the same
cheapest-offering finalization, and the same fused byte layouts of the
staged inputs and of the result buffer, byte for byte.

- Pods are pre-deduplicated into G groups (solver/problem.py), so the scan
  is over groups, not pods: 50k pods collapse to a few dozen steps.
- Each step (``_pack_step``) is dense tensor math over [bins x types
  (x resources)]: per-bin per-type fit counts by floor division, offering
  reachability by a 0/1 matmul, first-fit assignment of the whole group by
  an exclusive cumsum over the bin axis, and new-node opening by index
  arithmetic. ``pack`` runs it as a Python loop over the real groups of
  the G bucket: the padding rows past them are no-ops, so their steps are
  not issued (the JAX package compiles one program per bucket and runs
  them all; the bits are the same).
- Every bin keeps the full set of instance types that can still hold its
  contents; the finalization picks the cheapest available (type, zone,
  capacity-type) offering per bin with the cheapest-offering kernel
  (ops/offering_argmin.py, a hand-written CUDA kernel on the card and its
  plain PyTorch version on the CPU).

Numerical contract (as the JAX package's): resources are float32 in
canonical units (millicores / MiB / counts); counts are int32. ``EPS``
absorbs float32 rounding in capacity comparisons. Reductions that PyTorch
widens to int64 (``cumsum``, ``sum``) are narrowed back to int32 where the
JAX package's int32 arithmetic would wrap, so both give the same bits.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from .. import trace
from .offering_argmin import cheapest_offering

EPS = 1e-3

_I32 = torch.int32
_F32 = torch.float32


def _full(value, dtype, device) -> torch.Tensor:
    """A 0-d constant made on the device by a fill, not copied from the
    host: a host copy would stall the host until the card drains."""
    return torch.full((), value, dtype=dtype, device=device)


class BinState(NamedTuple):
    """Scan carry: the open-bin table."""

    cum: torch.Tensor        # [B,R] f32 committed resources (incl. daemonset overhead)
    tmask: torch.Tensor      # [B,T] bool instance types that can still hold this bin
    zmask: torch.Tensor      # [B,Z] bool zones still possible
    cmask: torch.Tensor      # [B,C] bool capacity types still possible
    np_id: torch.Tensor      # [B] i32 owning nodepool (-1 = unassigned)
    npods: torch.Tensor      # [B] i32 pods placed
    open: torch.Tensor       # [B] bool
    fixed: torch.Tensor      # [B] bool existing capacity (type pinned, not re-priced)
    alloc_cap: torch.Tensor  # [B,R] f32 per-bin allocatable ceiling (+inf for new bins)
    pm: torch.Tensor         # [B,A] i32 count of the bin's pods matching class a
    po: torch.Tensor         # [B,A] bool bin holds >=1 pod owning anti-affinity term a
    next_open: torch.Tensor  # [] i32 first unopened bin slot


class GroupBatch(NamedTuple):
    """Scan input: one row per (FFD-sorted) pod group."""

    req: torch.Tensor            # [G,R] f32
    count: torch.Tensor          # [G] i32 (0 = padding row)
    g_type: torch.Tensor         # [G,T] bool
    g_zone: torch.Tensor         # [G,Z] bool
    g_cap: torch.Tensor          # [G,C] bool
    g_np: torch.Tensor           # [G,NP] bool
    max_per_bin: torch.Tensor    # [G] i32 per-bin cap (INT32_MAX = unlimited)
    spread_class: torch.Tensor   # [G] i32 class whose per-bin COUNT the cap tracks (-1 none)
    single_bin: torch.Tensor     # [G] bool all replicas must share one bin
    match: torch.Tensor          # [G,A] bool affinity classes matching the group labels
    owner: torch.Tensor          # [G,A] bool hostname anti-affinity terms the group owns
    need: torch.Tensor           # [G,A] bool classes whose presence the bin must have
    strict_custom: torch.Tensor  # [G] bool excluded from unknown-pool bins


class PoolParams(NamedTuple):
    np_type: torch.Tensor  # [NP,T] bool
    np_zone: torch.Tensor  # [NP,Z] bool
    np_cap: torch.Tensor   # [NP,C] bool
    ds: torch.Tensor       # [NP,R] f32 daemonset overhead for a new node
    cap: torch.Tensor      # [NP,R] f32 per-pool allocatable ceiling for NEW bins


class PackResult(NamedTuple):
    assign: torch.Tensor        # [G,B] i32 pods of group g placed into bin b
    leftover: torch.Tensor      # [G] i32 pods that fit nowhere
    state: BinState
    chosen_t: torch.Tensor      # [B] i32 instance-type index (new bins)
    chosen_z: torch.Tensor      # [B] i32 zone index
    chosen_c: torch.Tensor      # [B] i32 capacity-type index
    chosen_price: torch.Tensor  # [B] f32 $/hr (+inf for fixed/empty bins)


def empty_state(B: int, T: int, Z: int, C: int, R: int, A: int = 1, *,
                device: Union[str, torch.device]) -> BinState:
    return BinState(
        cum=torch.zeros((B, R), dtype=_F32, device=device),
        tmask=torch.zeros((B, T), dtype=torch.bool, device=device),
        zmask=torch.zeros((B, Z), dtype=torch.bool, device=device),
        cmask=torch.zeros((B, C), dtype=torch.bool, device=device),
        np_id=torch.full((B,), -1, dtype=_I32, device=device),
        npods=torch.zeros((B,), dtype=_I32, device=device),
        open=torch.zeros((B,), dtype=torch.bool, device=device),
        fixed=torch.zeros((B,), dtype=torch.bool, device=device),
        alloc_cap=torch.full((B, R), float("inf"), dtype=_F32, device=device),
        pm=torch.zeros((B, A), dtype=_I32, device=device),
        po=torch.zeros((B, A), dtype=torch.bool, device=device),
        next_open=torch.zeros((), dtype=_I32, device=device),
    )


def _fit_counts(headroom: torch.Tensor, req: torch.Tensor) -> torch.Tensor:
    """[...,R] headroom, [R] request -> [...] how many replicas fit (f32).

    Axes the group doesn't request don't constrain; a group requesting
    nothing at all (padding) fits 'infinitely' and is neutralized by count=0.
    """
    pos = req > 0
    req_safe = torch.where(pos, req, torch.ones_like(req))
    per_axis = torch.where(pos, torch.floor((headroom + EPS) / req_safe),
                           _full(float("inf"), headroom.dtype, headroom.device))
    n = per_axis.amin(dim=-1)
    return torch.clamp(torch.nan_to_num(n, posinf=1e9), 0.0, 1e9)


def _offer_reachable(avail_f: torch.Tensor, zm: torch.Tensor,
                     cm: torch.Tensor) -> torch.Tensor:
    """avail [T,Z,C] f32, zm [...,Z] bool, cm [...,C] bool -> [...,T] bool:
    does type t have any available offering inside the zone x captype mask?
    A 0/1 matmul whose sums are exact small integers (TF32 is off)."""
    zc = zm.to(_F32)[..., :, None] * cm.to(_F32)[..., None, :]
    flat = zc.reshape(zc.shape[:-2] + (-1,))             # [...,Z*C]
    a = avail_f.reshape(avail_f.shape[0], -1)            # [T,Z*C]
    return (flat @ a.T) > 0.5                            # [...,T]


def _first_true(x: torch.Tensor) -> torch.Tensor:
    """Index of the first True of a 1-D bool tensor (0 when none), i32."""
    return torch.argmax(x.to(torch.uint8)).to(_I32)


def _take(x: torch.Tensor, i: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``x`` at the 0-d index tensor ``i`` along ``dim``, without the
    host sync that indexing with a 0-d tensor costs on the card."""
    return x.index_select(dim, i.reshape(1).long()).squeeze(dim)


def _pack_step(alloc: torch.Tensor, avail_f: torch.Tensor, pools: PoolParams,
               state: BinState, g: GroupBatch
               ) -> Tuple[BinState, Tuple[torch.Tensor, torch.Tensor]]:
    B, T = state.tmask.shape
    NP = pools.np_type.shape[0]
    dev = state.cum.device
    idx = torch.arange(B, dtype=_I32, device=dev)

    # ---- phase 1: fill existing/open bins, first-fit in bin order ----
    tm = state.tmask & g.g_type[None, :]                       # [B,T]
    zm = state.zmask & g.g_zone[None, :]                       # [B,Z]
    cm = state.cmask & g.g_cap[None, :]                        # [B,C]
    np_ok = torch.where(state.np_id >= 0,
                        g.g_np[torch.clamp(state.np_id, 0, NP - 1).long()],
                        # unknown-pool bins: pool-agnostic, but never for
                        # groups with strict custom-key constraints
                        ~g.strict_custom)
    # hostname (anti-)affinity, both directions of the k8s symmetry check
    pm_pos = state.pm > 0                                      # [B,A]
    conflict = ((pm_pos & g.owner[None, :]).any(dim=1)
                | (state.po & g.match[None, :]).any(dim=1))    # [B]
    need_ok = (pm_pos | ~g.need[None, :]).all(dim=1)           # [B]
    aff_ok = ~conflict & need_ok
    # a running node needs no market availability — only new capacity does
    reachable = _offer_reachable(avail_f, zm, cm) | state.fixed[:, None]  # [B,T]
    eff_alloc = torch.minimum(alloc[None, :, :], state.alloc_cap[:, None, :])  # [B,T,R]
    headroom = eff_alloc - state.cum[:, None, :]               # [B,T,R]
    n_fit_t = _fit_counts(headroom, g.req)                     # [B,T]
    valid_t = tm & reachable & (np_ok & aff_ok & state.open)[:, None]
    # a 0-d zero, not zeros_like: no [B,T] fill, and under the probe's
    # vmap no batch-size-dependent materialization
    zero_f = torch.zeros((), dtype=_F32, device=dev)
    n_fit = torch.where(valid_t, n_fit_t, zero_f).amax(dim=1).to(_I32)  # [B]
    # hostname-spread cap: maxSkew minus pods of the spread class already
    # in the bin; class-less caps apply per row
    A = state.pm.shape[1]
    cls_cnt = _take(state.pm, torch.clamp(g.spread_class, 0, A - 1), 1)  # [B]
    allowance = torch.where(g.spread_class >= 0,
                            torch.clamp(g.max_per_bin - cls_cnt, min=0),
                            g.max_per_bin)
    n_fit = torch.minimum(n_fit, allowance)
    # exclusive cumsum = first-fit order (int32 wrap as in the JAX package)
    prior = torch.cumsum(n_fit, dim=0).to(_I32) - n_fit
    zero = torch.zeros((), dtype=_I32, device=dev)
    take_ff = torch.minimum(torch.maximum(g.count - prior, zero), n_fit)  # [B]
    # single-bin groups: all replicas into the first bin that can hold any
    can = n_fit > 0
    is_first = (idx == _first_true(can)) & can.any()
    take = torch.where(g.single_bin,
                       torch.where(is_first, torch.minimum(g.count, n_fit), zero),
                       take_ff)
    take_sum = take.sum().to(_I32)
    rem = g.count - take_sum

    updated = take > 0
    cum1 = state.cum + take[:, None].to(_F32) * g.req[None, :]

    # ---- phase 2: open new bins for the remainder ----
    # the highest-weight pool (pools are weight-sorted) where a fresh node
    # can hold >=1 pod of this group
    tm_np = pools.np_type & g.g_type[None, :]                  # [NP,T]
    zm_np = pools.np_zone & g.g_zone[None, :]                  # [NP,Z]
    cm_np = pools.np_cap & g.g_cap[None, :]                    # [NP,C]
    reach_np = _offer_reachable(avail_f, zm_np, cm_np)         # [NP,T]
    head_np = (torch.minimum(alloc[None, :, :], pools.cap[:, None, :])
               - pools.ds[:, None, :])                         # [NP,T,R]
    n_per_t = _fit_counts(head_np, g.req)                      # [NP,T]
    valid_np_t = tm_np & reach_np & g.g_np[:, None]
    n_per_np = torch.where(valid_np_t, n_per_t, zero_f).amax(dim=1).to(_I32)  # [NP]
    n_per_np = torch.minimum(n_per_np, g.max_per_bin)
    ok_np = n_per_np >= 1
    np_star = _first_true(ok_np)                               # first True (weight order)
    any_ok = ok_np.any()
    n_per = _take(n_per_np, np_star)

    # a fresh bin satisfies presence requirements only by self-seeding
    seed_ok = (g.match | ~g.need).all()
    want_new = (rem > 0) & any_ok & seed_ok
    # single-bin groups never straddle phase-1 bins + a new bin
    want_new = want_new & ~(g.single_bin & (take_sum > 0))
    n_per_safe = torch.clamp(n_per, min=1)
    ceil_div = -torch.div(-rem, n_per_safe, rounding_mode="floor")
    n_new = torch.where(want_new, ceil_div, zero)
    n_new = torch.where(g.single_bin, torch.clamp(n_new, max=1), n_new)
    n_new = torch.minimum(n_new, B - state.next_open)          # bucket overflow clamp

    rel = idx - state.next_open
    is_new = (rel >= 0) & (rel < n_new)
    take_new = torch.where(
        is_new, torch.minimum(torch.maximum(rem - rel * n_per_safe, zero),
                              n_per_safe), zero)

    cum2 = torch.where(is_new[:, None],
                       _take(pools.ds, np_star)[None, :]
                       + take_new[:, None].to(_F32) * g.req[None, :],
                       cum1)

    # ---- shrink masks once, for updated + new bins together ----
    alloc_cap2 = torch.where(is_new[:, None], _take(pools.cap, np_star)[None, :],
                             state.alloc_cap)
    eff_alloc2 = torch.minimum(alloc[None, :, :], alloc_cap2[:, None, :])
    still_fits = (eff_alloc2 + EPS >= cum2[:, None, :]).all(dim=-1)  # [B,T]
    touched = (is_new | updated)[:, None]
    tmask2 = torch.where(is_new[:, None],
                         (_take(tm_np, np_star) & _take(reach_np, np_star))[None, :],
                         torch.where(updated[:, None], tm & reachable, state.tmask))
    tmask2 = tmask2 & (still_fits | ~touched)
    zmask2 = torch.where(is_new[:, None], _take(zm_np, np_star)[None, :],
                         torch.where(updated[:, None], zm, state.zmask))
    cmask2 = torch.where(is_new[:, None], _take(cm_np, np_star)[None, :],
                         torch.where(updated[:, None], cm, state.cmask))

    n_placed = take + take_new                                 # [B] i32
    placed = n_placed > 0
    new_state = BinState(
        cum=cum2,
        tmask=tmask2,
        zmask=zmask2,
        cmask=cmask2,
        np_id=torch.where(is_new, np_star, state.np_id),
        npods=state.npods + n_placed,
        open=state.open | is_new,
        fixed=state.fixed,
        alloc_cap=alloc_cap2,
        pm=state.pm + n_placed[:, None] * g.match[None, :].to(_I32),
        po=state.po | (placed[:, None] & g.owner[None, :]),
        next_open=state.next_open + n_new,
    )
    leftover = rem - take_new.sum().to(_I32)
    return new_state, (n_placed, leftover)


def _scan(alloc: torch.Tensor, avail_f: torch.Tensor, groups: GroupBatch,
          pools: PoolParams, init: BinState, n_groups: Optional[int] = None
          ) -> Tuple[BinState, torch.Tensor, torch.Tensor]:
    """The grouped-FFD scan: ``_pack_step`` over the first ``n_groups`` of
    the G groups in order (all G when None), each step a ``pack.step``
    trace span. Returns the final bin table, the [G,B] assignment and the
    [G] leftover. Plain tensor code only, so the batched probe can vmap it.

    The rows past ``n_groups`` must be padding (count 0): such a step
    places nothing, opens no bin and leaves every mask as it was, so it is
    not issued, and its assignment and leftover rows are zeros, the same
    bits the step would give."""
    G = groups.count.shape[0]
    n = G if n_groups is None else n_groups
    if not 0 <= n <= G:
        raise ValueError(f"n_groups {n} outside the group bucket {G}")
    state = init
    assign, leftover = [], []
    for gi in range(n):
        with trace.span("pack.step"):
            g = GroupBatch(*(f[gi] for f in groups))
            state, (a, lo) = _pack_step(alloc, avail_f, pools, state, g)
        assign.append(a)
        leftover.append(lo)
    dev = state.cum.device
    B = state.cum.shape[0]
    if n < G:
        assign += [torch.zeros((B,), dtype=_I32, device=dev)] * (G - n)
        leftover += [torch.zeros((), dtype=_I32, device=dev)] * (G - n)
    if not assign:
        return (state, torch.zeros((0, B), dtype=_I32, device=dev),
                torch.zeros((0,), dtype=_I32, device=dev))
    return state, torch.stack(assign), torch.stack(leftover)


def _finalize(state: BinState, avail: torch.Tensor, price: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cheapest available offering per new bin: (chosen_t, chosen_z,
    chosen_c, chosen_price), each shaped like ``state.open``. The bin
    table may carry leading axes (the batched probe's K): its rows are
    flattened into ONE call of the cheapest-offering kernel, since every
    bin is priced on its own against the one shared price panel."""
    T, Z, C = price.shape
    live = state.open & ~state.fixed & (state.npods > 0)
    inf = _full(float("inf"), _F32, price.device)
    p = torch.where(avail, price, inf).reshape(T, Z * C)
    zc = (state.zmask[..., :, None] & state.cmask[..., None, :]).reshape(-1, Z * C)
    best_v, best_i = cheapest_offering(state.tmask.reshape(-1, T).contiguous(),
                                       zc, p)
    best_v, best_i = best_v.reshape(live.shape), best_i.reshape(live.shape)
    chosen_t = torch.div(best_i, Z * C, rounding_mode="floor").to(_I32)
    chosen_z = (torch.div(best_i, C, rounding_mode="floor") % Z).to(_I32)
    chosen_c = (best_i % C).to(_I32)
    return chosen_t, chosen_z, chosen_c, torch.where(live, best_v, inf)


def pack(alloc: torch.Tensor, avail: torch.Tensor, price: torch.Tensor,
         groups: GroupBatch, pools: PoolParams, init: BinState,
         n_groups: Optional[int] = None) -> PackResult:
    """Run the grouped-FFD scan + cheapest-offering finalization.

    Shapes: G groups (padded), B bins (bucketed), T x Z x C lattice; every
    tensor on one device. Returns per-group-per-bin assignment counts,
    per-group leftover (infeasible / bucket overflow — the host retries
    with a bigger bucket), the final bin table, and each new bin's chosen
    offering. On CUDA the finalization always runs the CUDA kernel.
    ``n_groups`` (a host int; None = all G) is the count of real groups
    the scan issues steps for (``_scan``); the shapes stay the bucket's.
    """
    state, assign, leftover = _scan(alloc, avail.to(_F32), groups, pools, init,
                                    n_groups)
    chosen_t, chosen_z, chosen_c, chosen_price = _finalize(state, avail, price)
    return PackResult(assign=assign, leftover=leftover, state=state,
                      chosen_t=chosen_t, chosen_z=chosen_z, chosen_c=chosen_c,
                      chosen_price=chosen_price)


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """Little-endian bytes of a 4-/2-byte tensor, one row per leading index."""
    return x.contiguous().view(torch.uint8).reshape(x.shape[0], -1)


def packbits_rows(mask: torch.Tensor) -> torch.Tensor:
    """[B,N] bool -> [B,ceil(N/8)] u8, big-endian within each byte
    (numpy/jnp ``packbits(axis=1)``)."""
    B, N = mask.shape
    n8 = -(-N // 8)
    bits = torch.zeros((B, n8 * 8), dtype=torch.uint8, device=mask.device)
    bits[:, :N] = mask.to(torch.uint8)
    w = (1 << torch.arange(7, -1, -1, dtype=torch.int32, device=mask.device)
         ).to(torch.uint8)                                  # 128, 64, ..., 1
    return (bits.reshape(B, n8, 8) * w).sum(dim=2, dtype=torch.uint8)


def _encode_decode_set(res: PackResult, lean: bool = False) -> torch.Tensor:
    """Fuse everything the host decode needs into ONE uint8 buffer
    ([B+n_trailer, W]), byte-identical to the JAX package's encoder, so the
    host pays exactly one device→host copy.

    Full row layout (per bin): npods i32 | np_id i32 | chosen_t i32 |
    chosen_z i32 | chosen_c i32 | chosen_price f32 | open u8 | fixed u8 |
    packed tmask | packed zmask | packed cmask | assign-column int16[G] |
    cum f32[R] | alloc_cap f32[R] | pm int16[A] | packed po. Trailer rows:
    leftover int32[G] + next_open i32, zero-padded.

    ``lean`` keeps only what the single-device plan decode reads:
    np_id i16 | chosen_t i16 | chosen_z u8 | chosen_c u8 | chosen_price f32 |
    flags u8 (bit0 open, bit1 fixed) | packed tmask | packed zmask |
    packed cmask | assign int16[G].
    """
    st = res.state
    B, T = st.tmask.shape
    dev = st.cum.device

    masks_assign = [
        packbits_rows(st.tmask),
        packbits_rows(st.zmask),
        packbits_rows(st.cmask),
        _bytes(res.assign.to(torch.int16).T) if res.assign.shape[0]
        else torch.zeros((B, 0), dtype=torch.uint8, device=dev),
    ]
    if lean:
        # narrow dtypes hold: T < 2^15 types, Z/C < 2^8 zones/captypes
        if not (T < 2 ** 15 and st.zmask.shape[1] < 256
                and st.cmask.shape[1] < 256):
            raise ValueError("lean layout needs T < 2^15 and Z, C < 256")
        rows = torch.cat([
            _bytes(st.np_id.to(torch.int16)),
            _bytes(res.chosen_t.to(torch.int16)),
            res.chosen_z.to(torch.uint8)[:, None],
            res.chosen_c.to(torch.uint8)[:, None],
            _bytes(res.chosen_price),
            (st.open.to(torch.uint8) | (st.fixed.to(torch.uint8) << 1))[:, None],
        ] + masks_assign, dim=1)
    else:
        rows = torch.cat([
            _bytes(st.npods.to(_I32)),
            _bytes(st.np_id.to(_I32)),
            _bytes(res.chosen_t), _bytes(res.chosen_z), _bytes(res.chosen_c),
            _bytes(res.chosen_price),
            st.open.to(torch.uint8)[:, None],
            st.fixed.to(torch.uint8)[:, None],
        ] + masks_assign + [
            _bytes(st.cum),
            _bytes(st.alloc_cap),
            _bytes(st.pm.to(torch.int16)),
            packbits_rows(st.po),
        ], dim=1)
    W = rows.shape[1]
    tail = torch.cat([
        res.leftover.to(_I32).contiguous().view(torch.uint8),
        st.next_open.to(_I32).reshape(1).view(torch.uint8),
    ])
    n_trailer = -(-tail.shape[0] // W)
    flat = torch.zeros((n_trailer * W,), dtype=torch.uint8, device=dev)
    flat[: tail.shape[0]] = tail
    return torch.cat([rows, flat.reshape(n_trailer, W)], dim=0)


def pack_packed(alloc: torch.Tensor, avail: torch.Tensor, price: torch.Tensor,
                groups: GroupBatch, pools: PoolParams, init: BinState,
                lean: bool = False) -> torch.Tensor:
    """pack() + single-buffer result encoding (see _encode_decode_set)."""
    if lean and pools.np_type.shape[0] >= 2 ** 15:
        raise ValueError("lean layout needs NP < 2^15")
    return _encode_decode_set(pack(alloc, avail, price, groups, pools, init),
                              lean=lean)


class FieldSpec(NamedTuple):
    """One field of the staged solver input (see group_layout)."""

    name: str       # GroupBatch / PoolParams field
    offset: int     # byte offset in the fused buffer
    dtype: object   # np.float32 | np.int32 | np.uint8 (uint8 = bool)
    shape: tuple
    src: str        # solver.problem.Problem attribute holding the data
    fill: float     # pad value beyond the problem's true extent


def group_layout(G: int, T: int, Z: int, C: int, NP: int, A: int,
                 R: int) -> Tuple[Tuple[FieldSpec, ...], int]:
    """Static spec of the staged solver input: the byte layout of the fused
    GroupBatch+PoolParams upload, and which Problem attribute feeds each
    field with which pad fill. All 4-byte fields lead, so every 4-byte view
    stays aligned; bool fields trail as raw uint8. Returns the FieldSpecs
    and the total byte size."""
    fields = [
        # name, dtype, shape, Problem attr, pad fill
        ("req", np.float32, (G, R), "req", 0),
        ("count", np.int32, (G,), "count", 0),
        ("max_per_bin", np.int32, (G,), "max_per_bin", 0),
        ("spread_class", np.int32, (G,), "g_spread", -1),
        ("ds", np.float32, (NP, R), "ds_overhead", 0),
        ("cap", np.float32, (NP, R), "np_alloc_cap", np.inf),
        ("g_type", np.uint8, (G, T), "g_type", 0),
        ("g_zone", np.uint8, (G, Z), "g_zone", 0),
        ("g_cap", np.uint8, (G, C), "g_cap", 0),
        ("g_np", np.uint8, (G, NP), "g_np", 0),
        ("single_bin", np.uint8, (G,), "single_bin", 0),
        ("match", np.uint8, (G, A), "g_match", 0),
        ("owner", np.uint8, (G, A), "g_owner", 0),
        ("need", np.uint8, (G, A), "g_need", 0),
        ("strict_custom", np.uint8, (G,), "strict_custom", 0),
        ("np_type", np.uint8, (NP, T), "np_type", 0),
        ("np_zone", np.uint8, (NP, Z), "np_zone", 0),
        ("np_cap", np.uint8, (NP, C), "np_cap", 0),
    ]
    return _layout(fields)


def init_layout(B: int, R: int,
                A: int) -> Tuple[Tuple[FieldSpec, ...], int]:
    """Byte layout of the fused EXISTING-BIN upload. An existing bin's
    type/zone/captype masks are one-hot (the node IS one shape), so the
    host ships only per-bin indices + resource rows and the device
    rebuilds the masks (_unpack_init)."""
    fields = [
        ("e_used", np.float32, (B, R), "e_used", 0),
        ("e_alloc", np.float32, (B, R), "e_alloc", np.inf),
        ("e_pm", np.int32, (B, A), "e_pm", 0),
        ("e_type", np.int32, (B,), "e_type", -1),
        ("e_zone", np.int32, (B,), "e_zone", -1),
        ("e_cap", np.int32, (B,), "e_cap", -1),
        ("e_np", np.int32, (B,), "e_np", -1),
        ("e_po", np.uint8, (B, A), "e_po", 0),
    ]
    return _layout(fields)


def _layout(fields) -> Tuple[Tuple[FieldSpec, ...], int]:
    out, off = [], 0
    for name, dt, shape, src, fill in fields:
        out.append(FieldSpec(name, off, dt, shape, src, fill))
        off += int(np.prod(shape)) * np.dtype(dt).itemsize
    return tuple(out), off


_GROUP_FIELD_NAMES = frozenset(GroupBatch._fields)


def _field_values(buf: torch.Tensor, layout) -> dict:
    """Slice a fused uint8 buffer into its fields: 4-byte fields are
    reinterpreted in place where aligned (copied first where a combined
    buffer's split leaves them unaligned); uint8 fields stay uint8.

    ``buf`` may carry leading axes (the batched probe's [K,total] stack):
    every field then keeps them. A stack stays in place only when its row
    length is a multiple of 4, which the host's padding guarantees."""
    lead = tuple(buf.shape[:-1])
    vals = {}
    for f in layout:
        n = int(np.prod(f.shape))
        if f.dtype is np.uint8:
            vals[f.name] = buf[..., f.offset: f.offset + n].reshape(lead + f.shape)
        else:
            seg = buf[..., f.offset: f.offset + 4 * n]
            if seg.storage_offset() % 4 or any(s % 4 for s in seg.stride()[:-1]):
                seg = seg.clone()
            tgt = _F32 if f.dtype is np.float32 else _I32
            vals[f.name] = seg.view(tgt).reshape(lead + f.shape)
    return vals


def _unpack_inputs(buf: torch.Tensor, G: int, T: int, Z: int, C: int,
                   NP: int, A: int, R: int) -> Tuple[GroupBatch, PoolParams]:
    """Slice the fused uint8 upload back into GroupBatch + PoolParams
    (with the buffer's leading axes, if any)."""
    layout, _total = group_layout(G, T, Z, C, NP, A, R)
    vals = {k: (v.bool() if v.dtype == torch.uint8 else v)
            for k, v in _field_values(buf, layout).items()}
    groups = GroupBatch(**{k: v for k, v in vals.items()
                           if k in _GROUP_FIELD_NAMES})
    pools = PoolParams(**{k: v for k, v in vals.items()
                          if k not in _GROUP_FIELD_NAMES})
    return groups, pools


def _unpack_init(buf: Optional[torch.Tensor],
                 n_existing: Union[int, torch.Tensor],
                 B: int, T: int, Z: int, C: int, A: int, R: int,
                 device: Union[str, torch.device]) -> BinState:
    """Fused existing-bin upload → BinState (one-hot masks built on the
    device). ``buf`` None = no existing capacity. Rows >= n_existing are
    neutralized even when the buffer carries data there.

    ``n_existing`` is a host int for one pack, or a [K] int32 tensor on
    the device for a [K,total] stack of buffers (the batched probe: each
    probe keeps its own count of existing bins) or for one buffer that K
    shards share (the sharded pack: E on shard 0, 0 elsewhere); the bin
    table then carries the leading K axis."""
    if buf is None:
        return empty_state(B, T, Z, C, R, A, device=device)
    dev = buf.device
    layout, _total = init_layout(B, R, A)
    vals = _field_values(buf, layout)
    rows = torch.arange(B, dtype=_I32, device=dev)
    if isinstance(n_existing, torch.Tensor):
        n_e = n_existing.to(_I32)
        live = rows < n_e[..., None]
        next_open = n_e
    else:
        n_e = int(n_existing)
        live = rows < n_e
        next_open = _full(n_e, _I32, dev)

    def onehot(ix, n):
        return ix[..., None] == torch.arange(n, dtype=_I32, device=dev)

    zf = torch.zeros((), dtype=_F32, device=dev)
    return BinState(
        cum=torch.where(live[..., None], vals["e_used"], zf),
        tmask=onehot(vals["e_type"], T) & live[..., None],
        zmask=onehot(vals["e_zone"], Z) & live[..., None],
        cmask=onehot(vals["e_cap"], C) & live[..., None],
        np_id=torch.where(live, vals["e_np"],
                          torch.full((), -1, dtype=_I32, device=dev)),
        npods=torch.zeros(live.shape, dtype=_I32, device=dev),
        open=live, fixed=live.clone(),
        alloc_cap=torch.where(live[..., None], vals["e_alloc"],
                              torch.full((), float("inf"), dtype=_F32,
                                         device=dev)),
        pm=torch.where(live[..., None], vals["e_pm"],
                       torch.zeros((), dtype=_I32, device=dev)),
        po=vals["e_po"].bool() & live[..., None],
        next_open=next_open,
    )


def pack_packed_efused(alloc: torch.Tensor, avail: torch.Tensor,
                       price: torch.Tensor, gbuf: torch.Tensor,
                       init_buf: Optional[torch.Tensor], n_existing: int,
                       B: int, G: int, T: int, Z: int, C: int, NP: int,
                       A: int, lean: bool = False,
                       n_groups: Optional[int] = None) -> torch.Tensor:
    """Fully-fused pack: ONE upload for groups+pools, ONE (optional) for
    existing bins, ONE fused result buffer back. The scan issues steps for
    the first ``n_groups`` groups only (None = all G; see ``_scan``)."""
    if lean and NP >= 2 ** 15:
        raise ValueError("lean layout needs NP < 2^15")
    R_ = alloc.shape[1]
    groups, pools = _unpack_inputs(gbuf, G, T, Z, C, NP, A, R_)
    init = _unpack_init(init_buf, n_existing, B, T, Z, C, A, R_,
                        device=alloc.device)
    return _encode_decode_set(pack(alloc, avail, price, groups, pools, init,
                                   n_groups), lean=lean)


def pack_packed_combined(alloc: torch.Tensor, avail: torch.Tensor,
                         price: torch.Tensor, buf: torch.Tensor, split: int,
                         n_existing: int,
                         B: int, G: int, T: int, Z: int, C: int, NP: int,
                         A: int, lean: bool = False,
                         n_groups: Optional[int] = None) -> torch.Tensor:
    """One-upload pack WITH existing bins: groups+pools AND the existing-bin
    table ride ONE uint8 buffer (``buf[:split]`` / ``buf[split:]``). The
    scan issues steps for the first ``n_groups`` groups only (None = all
    G; see ``_scan``)."""
    if lean and NP >= 2 ** 15:
        raise ValueError("lean layout needs NP < 2^15")
    R_ = alloc.shape[1]
    groups, pools = _unpack_inputs(buf[:split], G, T, Z, C, NP, A, R_)
    init = _unpack_init(buf[split:], n_existing, B, T, Z, C, A, R_,
                        device=alloc.device)
    return _encode_decode_set(pack(alloc, avail, price, groups, pools, init,
                                   n_groups), lean=lean)


def seed_layout(B: int, T: int, Z: int, C: int, R: int,
                A: int) -> Tuple[Tuple[FieldSpec, ...], int]:
    """Byte layout of the fused SEEDED bin-table upload (the sharded
    solve's tail-bin merge). Unlike the existing-bin table (init_layout),
    merge seed rows are mid-pack state rebuilt from shard results: full
    cum/alloc_cap rows, multi-hot masks, OPEN non-fixed bins, live pm/po
    accumulators and an explicit next_open cursor, so they cannot ride the
    one-hot init staging. FieldSpec.src is unused here (the host writes
    rows straight from decoded shard state, solver/solve.py
    ``_merge_seed_np``)."""
    fields = [
        ("s_cum", np.float32, (B, R), "", 0),
        ("s_alloc", np.float32, (B, R), "", np.inf),
        ("s_pm", np.int32, (B, A), "", 0),
        ("s_np", np.int32, (B,), "", -1),
        ("s_npods", np.int32, (B,), "", 0),
        ("s_next", np.int32, (1,), "", 0),
        ("s_tmask", np.uint8, (B, T), "", 0),
        ("s_zmask", np.uint8, (B, Z), "", 0),
        ("s_cmask", np.uint8, (B, C), "", 0),
        ("s_open", np.uint8, (B,), "", 0),
        ("s_fixed", np.uint8, (B,), "", 0),
        ("s_po", np.uint8, (B, A), "", 0),
    ]
    return _layout(fields)


def _unpack_seed(buf: torch.Tensor, B: int, T: int, Z: int, C: int,
                 A: int, R: int) -> BinState:
    """Fused seed upload → BinState (reinterpretations and bool casts
    only)."""
    layout, _total = seed_layout(B, T, Z, C, R, A)
    vals = {k: (v.bool() if v.dtype == torch.uint8 else v)
            for k, v in _field_values(buf, layout).items()}
    return BinState(
        cum=vals["s_cum"], tmask=vals["s_tmask"], zmask=vals["s_zmask"],
        cmask=vals["s_cmask"], np_id=vals["s_np"], npods=vals["s_npods"],
        open=vals["s_open"], fixed=vals["s_fixed"],
        alloc_cap=vals["s_alloc"], pm=vals["s_pm"], po=vals["s_po"],
        next_open=vals["s_next"].reshape(()),
    )


def pack_packed_seeded(alloc: torch.Tensor, avail: torch.Tensor,
                       price: torch.Tensor, buf: torch.Tensor, split: int,
                       B: int, G: int, T: int, Z: int, C: int, NP: int,
                       A: int, lean: bool = False) -> torch.Tensor:
    """One-upload pack over a SEEDED bin table: groups+pools AND the merge
    seed BinState ride ONE uint8 buffer (``buf[:split]`` / ``buf[split:]``
    per seed_layout). The tail-bin merge of every sharded solve goes
    through here: one upload and one result fetch per merge. Its scan
    issues every step of the G bucket."""
    if lean and NP >= 2 ** 15:
        raise ValueError("lean layout needs NP < 2^15")
    R_ = alloc.shape[1]
    groups, pools = _unpack_inputs(buf[:split], G, T, Z, C, NP, A, R_)
    init = _unpack_seed(buf[split:], B, T, Z, C, A, R_)
    return _encode_decode_set(pack(alloc, avail, price, groups, pools, init),
                              lean=lean)


class ProbeSummary(NamedTuple):
    """Per-probe aggregates of a batched what-if pack (all [K])."""

    leftover: torch.Tensor   # i32 pods that fit nowhere
    n_new: torch.Tensor      # i32 new bins opened
    new_cost: torch.Tensor   # f32 $/hr summed over new bins
    cap_c: torch.Tensor      # i32 capacity-type index of the single new bin
                             # (valid when n_new == 1; -1 when none)
    flex: torch.Tensor       # i32 feasible-type count of that bin (offering
                             # flexibility, the spot→spot ≥15-type guard input)
    overflow: torch.Tensor   # bool bin table exhausted (host retries bigger B)


def _probe_summary(avail_f: torch.Tensor, state: BinState,
                   leftover: torch.Tensor, chosen_c: torch.Tensor,
                   chosen_price: torch.Tensor) -> ProbeSummary:
    """K what-if packs reduced to their aggregates (the JAX package's
    ``_probe_one`` over a leading probe axis): ``state`` fields are [K,B,·],
    ``leftover`` [K,G], ``chosen_*`` [K,B]."""
    K, B = state.open.shape
    dev = state.cum.device
    live = state.open & ~state.fixed & (state.npods > 0)                # [K,B]
    n_new = live.sum(dim=1).to(_I32)
    cost = torch.where(live, chosen_price,
                       torch.zeros((), dtype=_F32, device=dev)).sum(dim=1)
    left = leftover.sum(dim=1).to(_I32)
    # the first live bin of each probe (bin 0 when none): its offering
    # flexibility and capacity type
    b = torch.argmax(live.to(torch.uint8), dim=1)                       # [K]
    k = torch.arange(K, device=dev)
    reach = _offer_reachable(avail_f, state.zmask[k, b], state.cmask[k, b])
    flex = (state.tmask[k, b] & reach).sum(dim=1).to(_I32)
    zero = torch.zeros((), dtype=_I32, device=dev)
    cap_c = torch.where(n_new > 0, chosen_c[k, b],
                        torch.full((), -1, dtype=_I32, device=dev))
    overflow = (left > 0) & (state.next_open >= B)
    return ProbeSummary(leftover=left, n_new=n_new, new_cost=cost,
                        cap_c=cap_c, flex=torch.where(n_new > 0, flex, zero),
                        overflow=overflow)


def pack_probe_fused(alloc: torch.Tensor, avail: torch.Tensor,
                     price: torch.Tensor, gbufs: torch.Tensor,
                     init_bufs: Optional[torch.Tensor],
                     n_existing: torch.Tensor,
                     B: int, G: int, T: int, Z: int, C: int, NP: int,
                     A: int, n_groups: Optional[int] = None) -> torch.Tensor:
    """K consolidation what-ifs in ONE batched device pass over fused
    uploads; returns ONE [K,6] f32 buffer whose columns are
    ``ProbeSummary._fields``: leftover, n_new, new_cost, cap_c, flex,
    overflow (every count is far below f32's 2^24 exact-integer range).

    ``gbufs`` [K,·] and ``init_bufs`` [K,·] (None = no existing bins) are
    stacks of the single pack's fused buffers, each row padded to a
    multiple of 4 bytes so one pass unpacks the whole batch in place;
    ``n_existing`` is a [K] int32 tensor. The scan is vmapped over the
    probe axis (``torch.func.vmap`` of ``_scan``, whose batching rules keep
    one launch per op whatever K is); the finalization is not: the K
    probes' B bins are flattened into ONE call of the cheapest-offering
    kernel over K·B rows against the shared price panel, which is the
    TPU kernel under ``jax.vmap``. The scan issues steps for the first
    ``n_groups`` groups only (None = all G): the most real groups of any
    probe, since a probe with fewer meets zero-count rows, which are
    no-ops (``_scan``)."""
    R_ = alloc.shape[1]
    avail_f = avail.to(_F32)
    groups, pools = _unpack_inputs(gbufs, G, T, Z, C, NP, A, R_)
    K = gbufs.shape[0]
    if init_bufs is None:
        init = BinState(*(x.expand((K,) + tuple(x.shape)) for x in
                          empty_state(B, T, Z, C, R_, A, device=alloc.device)))
    else:
        init = _unpack_init(init_bufs, n_existing, B, T, Z, C, A, R_,
                            device=alloc.device)
    scan = torch.func.vmap(
        lambda g, p, s: _scan(alloc, avail_f, g, p, s, n_groups))
    state, _assign, leftover = scan(groups, pools, init)
    _t, _z, chosen_c, chosen_price = _finalize(state, avail, price)
    s = _probe_summary(avail_f, state, leftover, chosen_c, chosen_price)
    # ProbeSummary._fields IS the column order; the host decodes with
    # ProbeSummary(*buf.T) so the contract lives in one place
    return torch.stack([getattr(s, f).to(_F32) for f in ProbeSummary._fields],
                       dim=1)


# ---- the pack's analysis (the device cost model's per-shape figures) ----

# ops whose work is their input's elements, not their output's
_REDUCTIONS = frozenset(("sum", "amax", "amin", "max", "min", "argmax",
                         "argmin", "any", "all", "prod", "mean"))
# ops that allocate without reading or writing an element
_ALLOCATIONS = frozenset(("empty", "empty_strided", "empty_like"))


class PackAnalysis(NamedTuple):
    """One shape's figures, shaped as the device cost model reads a
    compiled executable's analysis (``costmodel.record_compiled``)."""

    flops: float
    bytes_accessed: float
    argument_size_in_bytes: int
    output_size_in_bytes: int
    temp_size_in_bytes: int

    def cost_analysis(self) -> dict:
        return {"flops": self.flops, "bytes accessed": self.bytes_accessed}

    def memory_analysis(self) -> "PackAnalysis":
        return self


def _flat(xs):
    for x in xs:
        if isinstance(x, (list, tuple)):
            yield from _flat(x)
        else:
            yield x


class _Tally(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the aten ops of a trace on the meta device: flops are each
    op's output elements (its input's for a reduction, 2·M·N·K for a
    matrix product), bytes its operands plus its outputs; views and bare
    allocations cost nothing. ``high`` is the high-water mark of the
    storage the trace allocated and still held.

    The scan repeats one step's ops G times at the same shapes, so an op
    that allocates its output is run on the meta device once per
    signature (op, argument shapes, strides and dtypes, other arguments);
    a repeat gets a fresh empty tensor of the recorded layout."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.nbytes = 0
        self.high = 0
        self._live = {}   # storage id -> bytes, until a sweep finds it freed
        self._held = 0    # their sum
        self._layouts = {}

    def note(self, flops: int, nbytes: int) -> None:
        self.flops += flops
        self.nbytes += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.is_view or func.namespace == "profiler":
            # a view, or a profiler range of a trace span: no work
            return func(*args, **kwargs)
        flat = list(_flat(args)) + list(_flat(kwargs.values()))
        ins = [t for t in flat if isinstance(t, torch.Tensor)]
        schema = func._schema
        fresh = not any(r.alias_info is not None for r in schema.returns)
        key = None
        if fresh:
            key = (func, tuple((tuple(x.shape), x.stride(), x.dtype)
                               if isinstance(x, torch.Tensor) else x
                               for x in flat), tuple(kwargs))
            try:
                layout = self._layouts.get(key)
            except TypeError:   # an unhashable argument: run the op
                layout, key = None, None
        if fresh and layout is not None:
            out = tuple(torch.empty_strided(shape, stride, dtype=dtype,
                                            device="meta")
                        for shape, stride, dtype in layout)
            out = out if len(schema.returns) > 1 else out[0]
        else:
            out = func(*args, **kwargs)
        outs = [t for t in _flat(out if isinstance(out, (list, tuple))
                                 else (out,))
                if isinstance(t, torch.Tensor)]
        if key is not None and layout is None:
            self._layouts[key] = tuple((tuple(t.shape), t.stride(), t.dtype)
                                       for t in outs)
        name = schema.name.split("::")[-1]
        if name not in _ALLOCATIONS:
            out_n = sum(t.numel() for t in outs)
            if name in ("mm", "bmm"):
                self.flops += 2 * out_n * ins[0].shape[-1]
            elif name in _REDUCTIONS:
                self.flops += max(t.numel() for t in ins)
            else:
                self.flops += out_n
            self.nbytes += sum(t.numel() * t.element_size()
                               for t in ins + outs)
        if fresh:
            for t in outs:
                st = t.untyped_storage()
                ref = st._weak_ref()
                if ref in self._live:
                    torch.UntypedStorage._free_weak_ref(ref)
                else:
                    self._live[ref] = st.nbytes()
                    self._held += st.nbytes()
            if self._held > self.high:
                # storage freed since the last sweep may still be counted:
                # drop it before a new high is taken
                expired = torch.UntypedStorage._expired
                for k in [k for k in self._live if expired(k)]:
                    self._held -= self._live.pop(k)
                    torch.UntypedStorage._free_weak_ref(k)
                self.high = max(self.high, self._held)
        return out


def pack_analysis(G: int, B: int, T: int, Z: int, C: int, NP: int, A: int,
                  R: int, lean: bool = True) -> PackAnalysis:
    """FLOPs, bytes accessed and memory of ``pack_packed_efused`` at one
    shape (no existing bins), from a trace on the meta device: nothing
    runs on a card or on the host, and the cheapest-offering kernel is not
    launched (its call counts ``offering_argmin.call_bytes`` and a compare
    per (bin, type, cell)). The pack is static-shaped, so the figures
    depend on the shape alone; they count all G scan steps, the shape's
    worst case (a pack of fewer real groups issues fewer), so they grow
    in proportion to G. The peak is the arguments plus the high-water mark
    of what the pack allocated."""
    from . import offering_argmin
    meta = torch.device("meta")
    _, g_total = group_layout(G, T, Z, C, NP, A, R)
    args = (torch.empty((T, R), dtype=_F32, device=meta),
            torch.empty((T, Z, C), dtype=torch.bool, device=meta),
            torch.empty((T, Z, C), dtype=_F32, device=meta),
            torch.empty((g_total,), dtype=torch.uint8, device=meta))
    tally = _Tally()
    offering_argmin.ANALYSIS.note = tally.note
    try:
        with tally:
            out = pack_packed_efused(*args, None, 0, B, G, T, Z, C, NP, A,
                                     lean=lean)
    finally:
        offering_argmin.ANALYSIS.note = None
    out_bytes = out.numel() * out.element_size()
    return PackAnalysis(
        flops=float(tally.flops), bytes_accessed=float(tally.nbytes),
        argument_size_in_bytes=sum(a.numel() * a.element_size() for a in args),
        output_size_in_bytes=out_bytes,
        temp_size_in_bytes=max(tally.high - out_bytes, 0))
