"""Bounding-volume hierarchy (counterpart of ``raytpu/bvh.py``).

The build is host-side and array-identical to raytpu's: the median-split
builder (numpy, or ``native/rt_native.cpp`` through
:mod:`raytpu_torch.native`, bit-identical), or the native binned SAH
builder; leaves padded to exactly ``leaf_size`` entries with can't-hit
dummies; eight octant-ordered preorder copies of the tree; the flat leaf
list; outlier-huge spheres split out of the tree into the tail of ``perm``.

Layout (raytpu's): ``nodes`` (8M, 9) f32 rows ``[min_x, min_y, min_z,
max_x, max_y, max_z, start, count, skip]`` — eight preorder copies, copy
``o`` ordering each interior node's children front to back for rays whose
direction-sign octant is ``o`` (bit 2 = dx < 0, bit 1 = dy < 0, bit 0 =
dz < 0); ``perm`` (P,) f32, permuted position -> original sphere index, -1
for a padding dummy; ``flat`` (8L, 9) the leaf rows of each copy in its
preorder (front-to-back) position.  Integers are stored as f32 (exact below
2^24).  Unpadded BVHs (``pad_leaves=False``, raytpu's variable leaves) hold
one copy of ``nodes`` with each leaf's own ``count`` and no flat list.

Two closest-hit policies sweep a BVH, picked by raytpu's rule
(:func:`sweep_of`): the flat sweep (K1c,
:func:`raytpu_torch.golden.hit_world_bvh`) tests every leaf box of
``flat`` and serves BVHs of at most :data:`FLAT_MAX_LEAVES` leaves a copy;
the skip-pointer walk (K1d, :func:`raytpu_torch.golden.hit_world_walk`)
follows ``nodes`` and serves the rest, unpadded BVHs included.
:func:`closest_hit_numpy` is the walk's scalar oracle.

:func:`refit` recomputes the boxes for moved spheres in torch, on the
scene's device: the leaf boxes as raytpu's in-graph refit does, and each
interior box of ``nodes`` as the union of the leaf boxes under it, so a
walk over a refit BVH culls as the built one does.  Here the port departs
from raytpu, whose refit voids the interior boxes to always-enter (a walk
over its refit BVH visits every node).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.weak import WeakTensorKeyDictionary

from raytpu_torch import native
from raytpu_torch.profiling import span
from raytpu_torch.scene import Scene

# The flat leaf-list sweep serves BVHs of at most this many leaves a copy,
# the skip-pointer walk the rest (raytpu's _FLAT_MAX_LEAVES,
# raytpu/kernels/megakernel.py:61-65).  raytpu chose 64 on a TPU; the port
# keeps it and chip_smoke.py phase 7f times both sweeps on either side.
# Tests monkeypatch it to force a sweep.
FLAT_MAX_LEAVES = 64
SWEEPS = ("flat", "walk")


def outlier_tail(perm, flat, leaf_size):
    """(base, count) of the split-out outlier tail, or None.  Derived from
    shapes only: ``perm`` rows past the padded leaf entries are the
    outliers."""
    if flat is None or not leaf_size:
        return None
    base = (flat.shape[0] // 8) * leaf_size
    cnt = int(perm.shape[0]) - base
    return (base, cnt) if cnt else None


@dataclasses.dataclass(frozen=True)
class BVH:
    nodes: torch.Tensor  # (8M, 9) f32 (padded leaves) or (M, 9) f32
    perm: torch.Tensor   # (P,) f32: permuted position -> sphere, -1 = dummy
    # leaf size when every leaf is padded to exactly this many entries,
    # None for raytpu's legacy variable leaves (no flat list: the walk
    # sweeps such a BVH)
    leaf_size: int | None = None
    flat: torch.Tensor | None = None  # (8L, 9) f32 leaf rows, octant copies
    built_by: str = ""   # "native median", "native sah" or "numpy median"
    spheres: int = 0     # spheres of the scene it was built for (0: unknown)
    # the closest-hit policy forced on this BVH ("flat" or "walk"), None for
    # raytpu's rule; set through with_sweep (chip_smoke.py and the tests)
    sweep: str | None = None

    @property
    def n_outliers(self) -> int:
        """Spheres split out of the tree: the tail of ``perm`` after the
        padded leaf entries, tested before the leaves."""
        tail = outlier_tail(self.perm, self.flat, self.leaf_size)
        return 0 if tail is None else tail[1]

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def n_trav(self) -> int:
        """Nodes per traversal walk (``nodes`` holds 8 octant copies when
        ``leaf_size`` is set)."""
        m = self.nodes.shape[0]
        return m // 8 if self.leaf_size else m

    @property
    def n_leaves(self) -> int:
        """Leaves per octant copy (0 without a flat leaf list)."""
        return 0 if self.flat is None else self.flat.shape[0] // 8

    @property
    def device(self) -> torch.device:
        return self.perm.device

    @functools.cached_property
    def walk_rows(self) -> torch.Tensor:
        """:func:`pack_walk_rows` of this BVH, the node rows the card's
        forward, K3, K5 and K6 read, packed at the first use and kept: a
        BVH's arrays are not changed in place (``refit`` and ``with_sweep``
        make new ones)."""
        return pack_walk_rows(self)

    @property
    def copies(self) -> int:
        """Octant copies of ``nodes``: 8 with padded leaves, else 1."""
        return 8 if self.leaf_size else 1

    def to(self, device) -> "BVH":
        return dataclasses.replace(
            self, nodes=self.nodes.to(device), perm=self.perm.to(device),
            flat=None if self.flat is None else self.flat.to(device))


def sweep_of(bvh: BVH) -> str:
    """The closest-hit policy that sweeps ``bvh``: ``bvh.sweep`` when
    forced, else raytpu's rule (megakernel.py:1515-1516, :1786-1787,
    gradkernel.py:1620-1621, :1903-1904): ``"flat"`` iff the BVH has a flat
    leaf list of at most :data:`FLAT_MAX_LEAVES` leaves a copy, else
    ``"walk"``."""
    if bvh.sweep is not None:
        return bvh.sweep
    return ("flat" if bvh.flat is not None
            and bvh.n_leaves <= FLAT_MAX_LEAVES else "walk")


def with_sweep(bvh: BVH, sweep: str) -> BVH:
    """``bvh`` with its closest-hit policy forced to ``sweep``.  The flat
    sweep needs padded leaves and a flat leaf list; the walk takes any
    BVH."""
    if sweep not in SWEEPS:
        raise ValueError(f"unknown sweep {sweep!r} (choose from {SWEEPS})")
    if sweep == "flat" and (bvh.flat is None or not bvh.leaf_size):
        raise ValueError("the flat sweep needs a BVH with padded leaves and "
                         "a flat leaf list (build_bvh(pad_leaves=True))")
    return dataclasses.replace(bvh, sweep=sweep)


# The walk's node rows in the 16-byte layout (pack_walk_rows) hold a
# node's start and count in 20 bits each: BVHs of fewer permuted rows
WALK_MAX_ROWS = 2**20


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as int32 tensors with the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def pack_walk_rows(bvh: BVH) -> torch.Tensor:
    """The walk's node rows in the 16-byte layout the card's forward and K3
    read (csrc/render_common.cuh ``WalkRow``) -> (copies * n_trav, 8) int32
    on the BVH's device, each row the bits of two float4: (min x, min y,
    min z, w0) and (max x, max y, max z, w1), ``w0 = skip | (start & 0xFF)
    << 24`` and ``w1 = start >> 8 | count << 12``.  skip takes 24 bits,
    start and count 20 each: a BVH of 2^24 or more nodes a copy, or of
    :data:`WALK_MAX_ROWS` or more permuted rows (a leaf's start and count
    lie below them), is refused.  The boxes' bits are copied as they are;
    :func:`walk_nodes` unpacks the rows."""
    rows = int(bvh.perm.shape[0])
    if rows >= WALK_MAX_ROWS or bvh.n_trav >= 2**24:
        raise ValueError(f"bvh: {rows} permuted rows, {bvh.n_trav} nodes a "
                         f"copy; the walk's 16-byte node rows hold starts "
                         f"and counts below {WALK_MAX_ROWS}, skips below "
                         f"2^24")
    nodes = bvh.nodes.contiguous()
    box = nodes[:, :6].view(torch.int32)
    start, count, skip = (nodes[:, k].to(torch.int64) for k in (6, 7, 8))
    w0 = _u32(skip | (start & 0xFF) << 24)
    w1 = _u32(start >> 8 | count << 12)
    return torch.stack([box[:, 0], box[:, 1], box[:, 2], w0,
                        box[:, 3], box[:, 4], box[:, 5], w1], dim=1)


def walk_nodes(rows: torch.Tensor) -> torch.Tensor:
    """The plain version of the kernels' unpacking of
    :func:`pack_walk_rows`: (N, 8) int32 rows -> (N, 9) f32 node rows
    [min xyz, max xyz, start, count, skip]."""
    box = rows[:, [0, 1, 2, 4, 5, 6]].contiguous().view(torch.float32)
    w0 = rows[:, 3].to(torch.int64) & 0xFFFFFFFF
    w1 = rows[:, 7].to(torch.int64) & 0xFFFFFFFF
    fields = (w0 >> 24 | (w1 & 0xFFF) << 8, w1 >> 12, w0 & 0xFFFFFF)
    return torch.cat([box, torch.stack(fields, dim=1).to(torch.float32)], 1)


def _pad_leaf_nodes(nodes: np.ndarray, perm: np.ndarray, leaf_size: int):
    """Pad every leaf to exactly ``leaf_size`` entries (dummies = -1 in
    perm; their scene rows become NaN and can never win a hit).  Leaf
    starts/counts are rewritten; node order and boxes are unchanged."""
    nodes = np.array(nodes, np.float32)
    perm = np.asarray(perm)
    new_perm: list[float] = []
    for r in nodes:
        count = int(r[7])
        if count == 0:
            continue
        start = int(r[6])
        r[6] = float(len(new_perm))
        r[7] = float(leaf_size)
        new_perm.extend(perm[start:start + count].tolist())
        new_perm.extend([-1.0] * (leaf_size - count))
    return nodes, np.asarray(new_perm, np.float32)


def _octant_orders(nodes: np.ndarray) -> np.ndarray:
    """(M, 9) preorder nodes -> (8*M, 9): eight preorder copies, copy ``o``
    visiting each interior node's children front to back for direction
    octant ``o`` (bit 2/1/0 set = dx/dy/dz < 0).  Children come from the
    skip-pointer layout (left = i + 1, right = skip(left)); the ordering
    axis is the children's axis of greatest centroid separation; a negative
    direction along it visits the larger-centroid child first.  start /
    count are copied verbatim: every copy indexes the same ``perm``."""
    nodes = np.asarray(nodes, np.float32)
    m = len(nodes)
    cent = (nodes[:, 0:3] + nodes[:, 3:6]) * 0.5
    out = np.empty((8, m, 9), np.float32)
    for o in range(8):
        neg = (bool(o & 4), bool(o & 2), bool(o & 1))
        rows = np.empty((m, 9), np.float32)
        pos = 0
        # (orig_index, out slot or -1): a first visit emits the row, a
        # second (slot >= 0) patches its skip pointer
        stack = [(0, -1)]
        while stack:
            i, slot = stack.pop()
            if slot >= 0:
                rows[slot, 8] = float(pos)
                continue
            my = pos
            rows[my] = nodes[i]
            pos += 1
            if nodes[i, 7] == 0:  # interior: order the children
                left = i + 1
                right = int(nodes[left, 8])
                axis = int(np.argmax(np.abs(cent[left] - cent[right])))
                first, second = left, right
                if (cent[left][axis] > cent[right][axis]) != neg[axis]:
                    first, second = right, left
                stack.append((i, my))
                stack.append((second, -1))
                stack.append((first, -1))
            else:
                rows[my, 8] = float(pos)
        assert pos == m
        out[o] = rows
    return out.reshape(8 * m, 9)


def _flat_leaves(nodes_arr: np.ndarray) -> np.ndarray:
    """(8*M, 9) octant-ordered nodes -> (8*L, 9) leaf rows, each copy's
    leaves in its preorder (front-to-back) position."""
    m = nodes_arr.shape[0] // 8
    copies = nodes_arr.reshape(8, m, 9)
    return np.stack([c[c[:, 7] > 0] for c in copies]).reshape(-1, 9)


# more outliers than this stay in the tree: each one is a sphere test that
# every ray runs before the leaves
_MAX_OUTLIERS = 4


def _median_numpy(center, radius, leaf_size, pad):
    """The numpy median-split builder -> (nodes (M, 9), perm (n,)): split
    at the centroid median of the longest axis, rounded up to a leaf_size
    multiple, until a node holds at most leaf_size spheres."""
    radius = np.abs(radius)
    lo = center - radius[:, None]
    hi = center + radius[:, None]
    nodes: list[list[float]] = []
    order: list[int] = []

    def rec(idx: np.ndarray) -> None:
        my = len(nodes)
        nodes.append([0.0] * 9)
        b_lo = lo[idx].min(axis=0) - pad
        b_hi = hi[idx].max(axis=0) + pad
        if len(idx) <= leaf_size:
            start = len(order)
            order.extend(int(i) for i in idx)
            nodes[my][:8] = [*b_lo, *b_hi, float(start), float(len(idx))]
        else:
            cent = center[idx]
            axis = int(np.argmax(cent.max(axis=0) - cent.min(axis=0)))
            sub = np.argsort(cent[:, axis], kind="stable")
            half = len(idx) // 2
            half = min(-(-half // leaf_size) * leaf_size, len(idx) - 1)
            nodes[my][:8] = [*b_lo, *b_hi, 0.0, 0.0]
            rec(idx[sub[:half]])
            rec(idx[sub[half:]])
        nodes[my][8] = float(len(nodes))  # skip = index after the subtree

    rec(np.arange(len(radius)))
    assert len(order) == len(radius)
    return np.asarray(nodes, np.float32), np.asarray(order, np.float32)


def build_bvh(scene: Scene, leaf_size: int = 64, pad: float = 1e-4,
              use_native: bool = True, pad_leaves: bool = True,
              builder: str = "median", split_outliers: bool = True) -> BVH:
    """BVH over the scene's spheres, built on the host; the arrays land on
    the scene's device and equal raytpu's ``build_bvh`` for the same
    arguments.

    ``builder="median"`` splits at the centroid median of the longest
    axis; ``"sah"`` takes the native binned surface-area heuristic (16
    bins per axis), falling back to median when the native library cannot
    be had, as raytpu does.  ``use_native`` picks the native median builder
    over the numpy one (bit-identical).  ``pad`` enlarges every box so a
    slab test on a face can only give false hits, never false misses.
    ``pad_leaves`` pads each leaf to ``leaf_size`` entries and stores the
    eight octant copies and the flat leaf list the kernels need.
    ``split_outliers`` (padded BVHs) keeps spheres of radius > 10x the
    median (at most ``_MAX_OUTLIERS``) out of the tree, in the tail of
    ``perm``; the sweeps test them before the leaves.  Median is raytpu's
    default because SAH lost every cell on a TPU (``raytpu/bvh.py:205-214``,
    a TPU measurement); on the card the choice is not measured yet.
    """
    if builder not in ("median", "sah"):
        raise ValueError(f"unknown builder {builder!r}")
    center = scene.center.detach().cpu().numpy().astype(np.float64)
    radius = scene.radius.detach().cpu().numpy().astype(np.float64)
    device = scene.center.device
    n_total = len(radius)
    keep = None
    outliers = np.empty(0, np.int64)
    if split_outliers and pad_leaves and n_total >= 2:
        r_abs = np.abs(radius)
        out_mask = r_abs > 10.0 * max(float(np.median(r_abs)), 1e-6)
        if int(out_mask.sum()) > _MAX_OUTLIERS:
            out_mask[:] = False
        if out_mask.any():
            keep = np.nonzero(~out_mask)[0]
            outliers = np.nonzero(out_mask)[0]
            center = center[keep]
            radius = radius[keep]

    built = None
    if use_native or builder == "sah":
        built = native.build_bvh_native(center, radius, leaf_size, pad,
                                        sah=builder == "sah")
    built_by = f"native {builder}"
    if built is None:
        built = _median_numpy(center, radius, leaf_size, pad)
        built_by = "numpy median"
    nodes_arr, perm_arr = built
    if pad_leaves:
        nodes_arr, perm_arr = _pad_leaf_nodes(nodes_arr, perm_arr, leaf_size)
        nodes_arr = _octant_orders(nodes_arr)
    perm_arr = np.asarray(perm_arr, np.float32)
    if keep is not None:
        # the tree's perm indexes the kept subset: map it to sphere ids
        # (dummies stay -1), then append the outliers' ids
        valid = perm_arr >= 0
        remapped = keep[np.maximum(perm_arr.astype(np.int64), 0)]
        perm_arr = np.where(valid, remapped.astype(np.float32), -1.0)
        perm_arr = np.concatenate([perm_arr, outliers.astype(np.float32)])
    flat = _flat_leaves(nodes_arr) if pad_leaves else None
    return BVH(nodes=torch.from_numpy(np.ascontiguousarray(nodes_arr)).to(
                   device),
               perm=torch.from_numpy(np.ascontiguousarray(
                   perm_arr, np.float32)).to(device),
               leaf_size=leaf_size if pad_leaves else None,
               flat=None if flat is None else torch.from_numpy(
                   np.ascontiguousarray(flat)).to(device),
               built_by=built_by, spheres=n_total)


def refit(bvh: BVH, scene: Scene, pad: float = 1e-4) -> BVH:
    """The BVH's boxes recomputed for the current geometry, topology,
    ``perm`` and leaf order kept, in torch on the scene's device.  Leaf
    boxes are exact (NaN dummies skipped, ``pad`` as in the build) in every
    octant copy of ``flat`` and of ``nodes``, as raytpu's refit computes
    them; every interior box of ``nodes`` is the union of the leaf boxes
    under it (:func:`subtree_leaves`), where raytpu's refit voids it to
    always-enter.  The interior pass runs in the ``raytpu.refit_nodes``
    span.  Needs padded leaves and a flat leaf list.

    Makes no host sync: every op is enqueued on the device, so a train
    step's refit runs while the previous step's kernels do.  That holds on
    a new ``perm``'s first refit too: :func:`perm_rows` and
    :func:`subtree_leaves` build their cached indices with fixed shapes
    on the device."""
    if not bvh.leaf_size or bvh.flat is None:
        raise ValueError("refit needs padded static leaves with a flat "
                         "leaf list")
    ls = int(bvh.leaf_size)
    nl = bvh.n_leaves
    pc = permute_scene(scene, bvh.perm)
    c = pc.center[:nl * ls].reshape(nl, ls, 3)
    r = pc.radius[:nl * ls].reshape(nl, ls, 1)
    # Python scalars, not device tensors (a host scalar copied to the
    # device waits for the stream); on f32 operands they compute in f32,
    # ``pad`` rounded to f32, the same values bit for bit
    lo_all, hi_all = c - r, c + r
    inf = float("inf")
    lo = torch.where(torch.isnan(lo_all), inf, lo_all).amin(dim=1) - pad
    hi = torch.where(torch.isnan(hi_all), -inf, hi_all).amax(dim=1) + pad

    flat = bvh.flat.to(torch.float32)
    fid = (flat[:, 6] / ls).to(torch.int64)                # start -> leaf
    new_flat = flat.clone()
    new_flat[:, 0:6] = torch.cat([lo, hi], dim=-1)[fid]

    nodes = bvh.nodes.to(torch.float32)
    with span("raytpu.refit_nodes"):
        # every row's box is the union over its subtree's leaves (a leaf
        # row's subtree is the leaf): one masked min and max of fixed shape
        under = subtree_leaves(bvh)[:, :, None]            # (rows, L, 1)
        node_lo = torch.where(under, lo, inf).amin(dim=1)
        node_hi = torch.where(under, hi, -inf).amax(dim=1)
        new_nodes = torch.cat([node_lo, node_hi, nodes[:, 6:]], dim=1)
    return dataclasses.replace(bvh, nodes=new_nodes, flat=new_flat)


# perm tensor -> {key: what was built from it}; weak, so it all goes with
# perm
_per_perm = WeakTensorKeyDictionary()


def _kept(perm: torch.Tensor, key: tuple, build):
    """``build()``, made once for the ``perm`` tensor and ``key``."""
    built = _per_perm.setdefault(perm, {})
    if key not in built:
        built[key] = build()
    return built[key]


def subtree_leaves(bvh: BVH) -> torch.Tensor:
    """(node rows, leaves) bool on the BVH's device: row ``k`` of ``nodes``
    holds leaf ``l`` in its subtree.  In the skip-pointer layout node ``j``
    of a copy lies under node ``i`` iff ``i <= j < skip(i)``, so a leaf row
    holds itself alone and the root every leaf; a leaf is numbered by its
    ``start / leaf_size``, as ``flat``'s rows are.  Built with fixed shapes
    (nothing waits on the device) and kept for a ``perm`` tensor, as
    :func:`perm_rows` keeps its indices: ``refit``, ``with_sweep`` and
    ``BVH.to`` keep ``perm`` and the topology."""
    nodes = bvh.nodes

    def build():
        copies, m, nl = bvh.copies, bvh.n_trav, bvh.n_leaves
        rows = nodes.reshape(copies, m, 9)
        pos = torch.arange(m, device=nodes.device)
        leaf = torch.where(rows[..., 7] > 0,
                           (rows[..., 6] / bvh.leaf_size).to(torch.int64),
                           nl)
        # each leaf's position in each copy by a scatter of fixed shape:
        # the interior rows go to a spare slot nl, dropped
        at = torch.full((copies, nl + 1), m, dtype=torch.int64,
                        device=nodes.device)
        at.scatter_(1, leaf, pos.expand(copies, m))
        at = at[:, None, :nl]                                # (copies, 1, L)
        skip = rows[..., 8].to(torch.int64)[..., None]       # (copies, m, 1)
        under = (pos[None, :, None] <= at) & (at < skip)
        return under.reshape(copies * m, nl)
    return _kept(bvh.perm, ("subtrees", nodes.device, nodes.shape[0],
                            bvh.n_leaves), build)


class PermRows(NamedTuple):
    """The indices a ``perm`` gives for a scene of ``n`` spheres: ``rows``
    (P,) int64, each permuted row's sphere (0 for a dummy); ``valid`` (P,)
    bool, the row holds a sphere; ``leaf_row`` (n,) int64, each sphere's
    permuted row (P for a sphere with none)."""
    rows: torch.Tensor
    valid: torch.Tensor
    leaf_row: torch.Tensor


def perm_rows(perm, n: int, device) -> PermRows:
    """:class:`PermRows` of ``perm`` for ``n`` spheres on ``device``,
    built there with fixed shapes (nothing waits on the device) and kept
    for a ``perm`` tensor: ``refit``, ``with_sweep`` and ``BVH.to`` on the
    BVH's device keep ``perm``, so every step of a fit reuses them, and a
    rebuilt BVH has a new ``perm``.  A BVH's arrays are not changed in
    place."""
    perm = torch.as_tensor(perm)
    device = torch.device(device)

    def build():
        p = perm.to(device=device, dtype=torch.int64)
        valid = p >= 0
        count = p.shape[0]
        # each sphere's row by a scatter of fixed shape: the dummies' rows
        # go to a spare slot n, dropped
        leaf_row = torch.full((n + 1,), count, dtype=torch.int64,
                              device=device)
        leaf_row.scatter_(0, torch.where(valid, p, n),
                          torch.arange(count, device=device))
        return PermRows(p.clamp(min=0), valid, leaf_row[:n])
    return _kept(perm, ("rows", device, n), build)


def permute_scene(scene: Scene, perm) -> Scene:
    """The scene in BVH leaf order (leaves contiguous).  Entries with
    ``perm == -1`` are padding dummies: their rows become NaN (center,
    radius, albedo, mat_param; mat_type 0), so every sweep's root test
    fails on them and they never win.  Differentiable: gradients of the
    permuted leaves flow back to the scene's.  Waits on no device: the
    indices come from :func:`perm_rows`, the fills are scalars."""
    idx = perm_rows(perm, scene.count, scene.center.device)
    valid, pc, nan = idx.valid, idx.rows, float("nan")
    return Scene(
        center=torch.where(valid[:, None], scene.center[pc], nan),
        radius=torch.where(valid, scene.radius[pc], nan),
        mat_type=torch.where(valid, scene.mat_type[pc], 0),
        albedo=torch.where(valid[:, None], scene.albedo[pc], nan),
        mat_param=torch.where(valid, scene.mat_param[pc], nan),
    )


# ---------------------------------------------------------------------------
# numpy reference traversal (the layout's scalar oracle)

def closest_hit_numpy(bvh_nodes: np.ndarray, centers: np.ndarray,
                      radii: np.ndarray, ro: np.ndarray, rd: np.ndarray,
                      t_min: float = 1e-3, n_outliers: int = 0):
    """Scalar skip-pointer traversal -> (t, permuted index) or (inf, -1).

    centers / radii in permuted order; float64; ``n_outliers`` tail
    entries are tested before the walk."""
    nodes = np.asarray(bvh_nodes, np.float64)
    m = len(nodes)
    inv = np.where(rd != 0, 1.0 / np.where(rd == 0, 1.0, rd), np.inf)
    best_t, best_i = np.inf, -1
    for i in range(len(centers) - n_outliers, len(centers)):
        oc = ro - centers[i]
        a = rd @ rd
        half_b = oc @ rd
        c = oc @ oc - radii[i] * radii[i]
        disc = half_b * half_b - a * c
        if disc >= 0:
            sq = np.sqrt(disc)
            root = (-half_b - sq) / a
            if root < t_min:
                root = (-half_b + sq) / a
            if root >= t_min and root < best_t:
                best_t, best_i = root, i
    node = 0
    while node < m:
        b = nodes[node]
        t1 = (b[0:3] - ro) * inv
        t2 = (b[3:6] - ro) * inv
        tnear = max(np.minimum(t1, t2).max(), t_min)
        tfar = min(np.maximum(t1, t2).min(), best_t)
        # NaN (origin on a padded face) counts as a hit, as in the sweeps
        hit_box = not (tnear > tfar)
        start, count, skip = int(b[6]), int(b[7]), int(b[8])
        if hit_box and count > 0:
            for i in range(start, start + count):
                oc = ro - centers[i]
                a = rd @ rd
                half_b = oc @ rd
                c = oc @ oc - radii[i] * radii[i]
                disc = half_b * half_b - a * c
                if not disc >= 0:  # NaN (padding dummy) -> skip
                    continue
                sq = np.sqrt(disc)
                root = (-half_b - sq) / a
                if root < t_min:
                    root = (-half_b + sq) / a
                if root >= t_min and root < best_t:
                    best_t, best_i = root, i
        node = node + 1 if (hit_box and count == 0) else skip
    return best_t, best_i
