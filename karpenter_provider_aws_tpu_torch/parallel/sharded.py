"""Pod-axis sharded solve: D pod shards as one batched pack on a device.

The port of the JAX package's ``parallel/sharded.py``. The reference
shards the pod dimension of every group over a device mesh: each device
packs its slice of every group against the replicated lattice, and
``psum`` reduces the totals. Here the D shards are one batched pass on
the Solver's device (``local_pack``), or, on a mesh of W > 1 ranks, one
such pass on each rank's card over its contiguous block of shards, the
results gathered to rank 0 in shard order (parallel/ranks.py; the same
bytes and float32 cost):

1. **Shard pods, share the lattice.** ``split_counts`` gives each shard
   an equal slice of every group's pod count; groups whose pods must
   co-locate stay whole on one shard, and groups that need a presence
   only existing bins can seed go whole to shard 0. The lattice and the
   fused group buffer are shared by all shards: only the [D,G] count
   split and the [D] existing-bin count differ per shard.
2. **One scan for all shards.** ``torch.func.vmap`` of the grouped-FFD
   scan (ops/binpack.py ``_scan``) over the D shards, one launch per op
   whatever D is; then ONE call of the cheapest-offering kernel over the
   D·B bins of all shards (ops/binpack.py ``_finalize`` flattens leading
   axes). Existing bins live on shard 0 only: every shard unpacks the
   same init buffer, with its existing-bin count zeroed off shard 0, so
   no real node is filled D times.
3. **Reduce in the reference's order.** Each ``psum`` becomes a sum over
   the shard axis, and the float32 cost is summed as XLA's CPU backend
   sums it on the reference's 8-way CPU mesh (``_xla_sum_f32`` per shard,
   then shard by shard in index order), so that the tail-bin merge
   decision of the Solver (solver/solve.py ``_decode_sharded``) sees the
   same bits.

Each shard's result is encoded into the single-device decode layout and
the D buffers stack to ONE [D, B+n, W] uint8 buffer, so the host pays
one device→host copy for all shards. Nothing is compiled at run time.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import binpack

_I32 = torch.int32
_F32 = torch.float32

# Which tensor of the sharded pack carries the leading shard axis and
# which all shards share (the reference's partition-spec table: "pods" =
# split over the shard axis, "shared" = one copy for every shard).
# Inputs: the lattice trio and the fused group+pool and existing-bin
# buffers are shared (shard 0 alone materializes the existing table);
# the pod-count split and the existing-bin count carry the shard axis.
# Outputs: the decode buffers stack per shard; the totals are reduced.
PARTITION_SPECS = {
    "alloc": "shared",        # [T,R]   lattice allocatable
    "avail": "shared",        # [T,Z,C] lattice availability (ICE-masked)
    "price": "shared",        # [T,Z,C] lattice prices
    "gbuf": "shared",         # fused group+pool upload (u8)
    "count_split": "pods",    # [D,G] per-shard pod counts
    "init_buf": "shared",     # fused existing-bin upload (u8)
    "n_existing": "pods",     # [D] E on shard 0, 0 elsewhere
    "packed": "pods",         # [D, B+n_trailer, W] per-shard decode buffers
    "total_cost": "reduced",  # summed over shards
    "total_nodes": "reduced",
    "total_leftover": "reduced",
}


def replicated_sharding(mesh) -> tuple:
    """The shared placement over ``mesh``: the token the resident input
    cache accepts for a buffer every shard reads (solver/pipeline.py
    ``ResidentInputCache.upload(sharding=)``). The Solver's device
    stores it once; a mesh's other ranks keep their own copies
    (parallel/ranks.py)."""
    return ("replicated", int(mesh.shards), mesh.axis)


def split_counts(count: np.ndarray, n_devices: int,
                 keep_whole: Optional[np.ndarray] = None,
                 pin_shard0: Optional[np.ndarray] = None) -> np.ndarray:
    """[G] pod counts -> [D,G] balanced split (device d gets ~count/D).

    Groups flagged in ``keep_whole`` (co-location groups) are not split:
    each lands entirely on one shard, round-robin. Groups flagged in
    ``pin_shard0`` (presence-requiring ``need`` groups) go whole to shard 0,
    the only shard holding existing bins and their bound-pod affinity
    seeding (e_pm/e_po) — elsewhere their needs could never be met.
    """
    base = count // n_devices
    extra = count % n_devices
    out = np.tile(base, (n_devices, 1))
    for d in range(n_devices):
        out[d] += (d < extra).astype(count.dtype)
    if keep_whole is not None and keep_whole.any():
        whole = keep_whole.copy()
        if pin_shard0 is not None:
            whole &= ~pin_shard0
        whole = np.nonzero(whole)[0]
        for i, g in enumerate(whole):
            out[:, g] = 0
            out[i % n_devices, g] = count[g]
    if pin_shard0 is not None and pin_shard0.any():
        for g in np.nonzero(pin_shard0)[0]:
            out[:, g] = 0
            out[0, g] = count[g]
    return out


def device_split_counts(gbuf: torch.Tensor, D: int, offset: int,
                        G: int) -> torch.Tensor:
    """Balanced [D,G] int32 pod-count split derived on the device from the
    fused group buffer's resident ``count`` field (``offset`` from
    ops/binpack.group_layout). The resident microloop uses this instead
    of uploading a host-built split every pass. Equal to ``split_counts``
    with no keep_whole/pin flags (the microloop leaves to the standard
    solve when co-location or shard-0 pinning is in play): shard d gets
    count // D plus one of the count % D remainders."""
    spec = binpack.FieldSpec("count", offset, np.int32, (G,), "count", 0)
    count = binpack._field_values(gbuf, (spec,))["count"]
    base = torch.div(count, D, rounding_mode="floor")
    extra = count - base * D
    d = torch.arange(D, dtype=_I32, device=gbuf.device)[:, None]
    return base[None, :] + (d < extra[None, :]).to(_I32)


def shard_groups(count_split: np.ndarray) -> np.ndarray:
    """Per-shard pod load [D] of a split — balanced splitting plus the
    round-robin whole-group assignment and the shard-0 pinning all land
    here. max/mean of this vector is the
    ``karpenter_solver_shard_imbalance_ratio`` gauge: 1.0 is a
    perfectly balanced mesh; a pinned-heavy workload (everything
    co-located or need-seeded) shows up as shard 0 carrying the wave."""
    return count_split.sum(axis=1)


class ShardedPack(NamedTuple):
    """Per-shard pack results and the totals reduced over shards (0-d
    tensors on the device).

    ``packed`` stacks each shard's fused decode buffer (ops/binpack.py
    ``_encode_decode_set``, full layout) along a leading shard axis
    ([D, B+n, W] u8): the host fetches ONE buffer for all shards and
    decodes each shard's bin table exactly like a single-device result.
    """

    packed: torch.Tensor          # [D, B+n_trailer, W] u8
    total_cost: torch.Tensor      # f32 $/hr of live new bins, all shards
    total_nodes: torch.Tensor     # i32 live new bins, all shards
    total_leftover: torch.Tensor  # i32 pods no bin could take, all shards


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis one element at a time, from 0.0, in index
    order (float32 adds are exact IEEE operations on both devices)."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for k in range(x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def _lanes_sum(x: torch.Tensor, lanes: int = 8) -> torch.Tensor:
    """Sum over the last axis as a vectorized loop does: ``lanes``
    accumulators over consecutive chunks, halved pairwise into one, then
    the remainder in order."""
    n = x.shape[-1] // lanes * lanes
    acc = torch.zeros(x.shape[:-1] + (lanes,), dtype=x.dtype, device=x.device)
    for i in range(0, n, lanes):
        acc = acc + x[..., i: i + lanes]
    while acc.shape[-1] > 1:
        h = acc.shape[-1] // 2
        acc = acc[..., :h] + acc[..., h:]
    out = acc[..., 0]
    for k in range(n, x.shape[-1]):
        out = out + x[..., k]
    return out


def _xla_sum_f32(x: torch.Tensor, window: int = 32) -> torch.Tensor:
    """Sum over the last axis in the order in which XLA's CPU backend sums
    the reference's per-shard cost: a vector of at most ``window``
    elements stays in its fused loop, which sums it in 8 lanes; a longer
    one is cut into blocks of ``window`` summed in order (zero padded),
    repeated while more than ``window`` partials remain, and the last
    partials are summed in order. Bin tables are bucketed to multiples
    of 32."""
    if x.shape[-1] <= window:
        return _lanes_sum(x)
    while x.shape[-1] > window:
        n = -(-x.shape[-1] // window) * window
        if n != x.shape[-1]:
            x = torch.nn.functional.pad(x, (0, n - x.shape[-1]))
        x = _seq_sum(x.reshape(x.shape[:-1] + (n // window, window)))
    return _seq_sum(x)


def local_pack(alloc: torch.Tensor, avail: torch.Tensor, price: torch.Tensor,
               gbuf: torch.Tensor, init_buf: Optional[torch.Tensor],
               n_existing: int, counts: torch.Tensor, B: int, G: int,
               T: int, Z: int, C: int, NP: int, A: int):
    """Pack the shards of ``counts`` ([n,G] int32 on the device of
    ``alloc``) as one batched pass: a vmapped ``_scan`` and one
    ``_finalize`` over their n·B bins. The first of them alone holds the
    ``n_existing`` existing bins of ``init_buf`` (None: no existing
    capacity): shard 0, or 0 bins for a block without it. Returns
    the stacked decode buffers [n, B+n_trailer, W] u8, each shard's
    float32 cost [n] (``_xla_sum_f32``), and the live new bins and
    leftover pods of these shards (0-d int32)."""
    dev = alloc.device
    R_ = alloc.shape[1]
    n = int(counts.shape[0])
    groups, pools = binpack._unpack_inputs(gbuf, G, T, Z, C, NP, A, R_)
    if init_buf is None:
        init = binpack.BinState(*(
            x.expand((n,) + tuple(x.shape)) for x in
            binpack.empty_state(B, T, Z, C, R_, A, device=dev)))
    else:
        # E on shard 0, 0 elsewhere, made on the device
        n_e = torch.where(torch.arange(n, device=dev) == 0,
                          torch.full((), int(n_existing), dtype=_I32,
                                     device=dev),
                          torch.zeros((), dtype=_I32, device=dev))
        init = binpack._unpack_init(init_buf, n_e, B, T, Z, C, A, R_,
                                    device=dev)
    avail_f = avail.to(_F32)

    def one(cnt, st):
        return binpack._scan(alloc, avail_f, groups._replace(count=cnt),
                             pools, st)

    state, assign, leftover = torch.func.vmap(one)(counts, init)
    chosen_t, chosen_z, chosen_c, chosen_price = binpack._finalize(
        state, avail, price)
    packed = torch.stack([
        binpack._encode_decode_set(binpack.PackResult(
            assign=assign[d], leftover=leftover[d],
            state=binpack.BinState(*(f[d] for f in state)),
            chosen_t=chosen_t[d], chosen_z=chosen_z[d], chosen_c=chosen_c[d],
            chosen_price=chosen_price[d]))
        for d in range(n)])
    live = state.open & ~state.fixed & (state.npods > 0)              # [n,B]
    local_cost = _xla_sum_f32(torch.where(
        live, chosen_price, torch.zeros((), dtype=_F32, device=dev)))  # [n]
    return (packed, local_cost, live.sum().to(_I32),
            leftover.sum().to(_I32))


def sharded_pack(mesh, alloc: torch.Tensor, avail: torch.Tensor,
                 price: torch.Tensor, gbuf: torch.Tensor,
                 init_buf: Optional[torch.Tensor], n_existing: int,
                 count_split, B: int, G: int, T: int, Z: int, C: int,
                 NP: int, A: int, resident=None, ranks=None) -> ShardedPack:
    """Run the pod-sharded pack of ``mesh``'s D shards on the device of
    ``alloc``: one batched pass there, or, for a mesh that runs the rank
    program (``mesh.group``), each rank's block of shards on its own card
    (parallel/ranks.py), gathered back here in shard order.

    ``gbuf``/``init_buf`` are the fused group+pool / existing-bin uploads
    (solver/solve.py ``_fused_inputs_np`` / ``_fused_init_np``; init_buf
    None = no existing capacity), device tensors or resident cache
    entries; ``count_split`` is the [D,G] split (``split_counts`` on the
    host, or ``device_split_counts`` on the device). Shard 0 alone holds
    the ``n_existing`` existing bins. ``resident`` (the microloop's
    resident combined buffer, ``ranks.Resident``) lets the ranks keep that
    buffer and take only its delta; ``ranks`` is the rank set to run on
    (None: the process's shared set for the mesh).
    """
    D = int(mesh.shards)
    dev = alloc.device
    counts = torch.as_tensor(count_split, dtype=_I32).to(dev)
    if tuple(counts.shape) != (D, G):
        raise ValueError(f"count_split is {tuple(counts.shape)}, the mesh "
                         f"needs ({D}, {G})")
    if getattr(mesh, "group", False):
        from . import ranks as _ranks
        rs = ranks if ranks is not None else _ranks.acquire(mesh, dev)
        return rs.pack(mesh, alloc, avail, price, gbuf, init_buf,
                       n_existing, counts, B, G, T, Z, C, NP, A,
                       resident=resident)
    packed, local_cost, nodes, leftover = local_pack(
        alloc, avail, price, gbuf, init_buf, n_existing, counts, B, G, T,
        Z, C, NP, A)
    return ShardedPack(packed=packed, total_cost=_seq_sum(local_cost),
                       total_nodes=nodes, total_leftover=leftover)
