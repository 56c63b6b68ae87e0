"""Smoke run of the main path on an NVIDIA GPU, checked against oracles.

    python chip_smoke.py             # one card: phases 1-5
    python chip_smoke.py --chips 4   # four cards: phase 1 and the
                                     # distributed Domain only

Run from the repository root. Every phase runs in this one process, so
exactly one JAX process holds the card.

  1. device    JAX's first device must be a GPU; the card's name and power
               limit come from nvidia-smi in a child process.
  2. kernels   the Pallas stencil kernel, compiled for the card at the
               timed shapes (1M particles, level 5, cap 64), against the
               plain XLA stencil: counts, density, density with per-particle
               mass, and two disjoint sets (cross).
  3. timing    the whole sync+counts and sync+density steps (Domain.sync
               followed by cell_list_neighbor_counts / sph_density_step,
               10 scanned steps with a drift each step) with the kernel and
               with the plain stencil, in turns xla, kernel, kernel, xla.
  4. oracle    the main path after the timed steps against a float64 numpy
               brute force on 1,024 random particles, and the 2M-key octree
               build against the cornerstone invariants and the native
               host build.
  5. reach     the tiered adaptive-h cell list on a Plummer sphere against
               the tree path, and find_neighbors once.
  6. --chips 4 Domain.sync under shard_map on 4 x 1M particles with the
               dense and the ragged protocol: the psum of owned neighbour
               counts must equal the single-card cell-list sum.

Neighbour counts may differ from a reference only by pairs whose distance
lies within a relative 1e-6 of the search radius (the float32 distance sum
may be contracted or reordered differently); every comparison counts those
pairs and bounds the difference by them. Densities agree to a relative
1e-5. A failed check raises, so the script exits non-zero and prints no
result line. The last line of a passing run is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from cstone_tpu import native
from cstone_tpu.domain.domain import Domain, sync_with_retry
from cstone_tpu.domain.layout import leaf_layout_from_counts
from cstone_tpu.models.sph import SphState, sph_density_step
from cstone_tpu.ops.pallas_stencil import stencil_pallas
from cstone_tpu.sfc import PERIODIC, compute_sfc_keys, make_box
from cstone_tpu.traversal import celllist
from cstone_tpu.traversal.celllist import (
    cell_list_neighbor_counts,
    choose_cell_level,
    default_cell_cap,
    ell_pack_gather,
    rowmajor_cell_perm,
    stencil_xla,
)
from cstone_tpu.traversal.neighbors import (
    _find_neighbors_impl,
    find_neighbors,
    make_ns_view,
)
from cstone_tpu.traversal.tiered import (
    cell_list_neighbor_counts_tiered,
    choose_tier_levels,
    tier_caps,
)
from cstone_tpu.tree.csarray import (
    MAX_UINT32,
    _compute_octree_jit,
    default_init_level,
    update_octree,
)
from cstone_tpu.tree.octree import build_linked_octree
from cstone_tpu.utils.compile_cache import configure_compile_cache
from cstone_tpu.utils.workloads import adaptive_h, truncated_plummer_coords

# the sync_1M_uniform configuration: 1M uniform particles in the periodic
# unit box, h = 0.012 (~58 neighbours), bucket 64, 64-bit Hilbert keys
SYNC_N = 1_000_000
SYNC_H = 0.012
SYNC_STEPS = 10
TREE_N = 2_000_000
TREE_BUCKET = 16
REACH_N = 262_144
ORACLE_SAMPLE = 1024
FLIP_REL = 1e-6  # threshold-flip band: |d / r - 1| < FLIP_REL
DENSITY_RTOL = 1e-5

COMPILE_SECONDS = {}


class SmokeFailure(RuntimeError):
    """A phase's check failed."""


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def stencil_used(stencil):
    """The cell-list entry points traced inside run `stencil`."""
    old = celllist._stencil_override
    celllist._stencil_override = stencil
    try:
        yield
    finally:
        celllist._stencil_override = old


def timed_compile(name: str, fn, *args):
    """AOT-compile a jitted fn for args; records the seconds and prints the
    program's memory analysis."""
    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    COMPILE_SECONDS[name] = time.perf_counter() - t0
    log(f"[compile] {name}: {COMPILE_SECONDS[name]:.1f} s; "
        f"memory_analysis: {compiled.memory_analysis()}")
    return compiled


# ---------------------------------------------------------------- phase 1
def require_gpu(count: int = 1):
    devices = jax.devices()
    require(devices[0].platform == "gpu",
            f"no GPU: JAX's first device is {devices[0].platform!r}")
    require(len(devices) >= count,
            f"needs {count} GPUs, JAX sees {len(devices)}")
    return devices


def card_info() -> str:
    """nvidia-smi's name and power limit, one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


# ---------------------------------------------------------------- phase 2
def uniform_positions(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).random((n, 3), dtype=np.float32)


@partial(jax.jit, static_argnames=("level", "cap"))
def _pack(x, y, z, h, m, box, level, cap):
    keys = compute_sfc_keys(x, y, z, box, jnp.uint64)
    keys, x, y, z, h, m = jax.lax.sort((keys, x, y, z, h, m), num_keys=1)
    perm, _ = rowmajor_cell_perm(level)
    (px, py, pz, ph, pm), valid, _, ovf = ell_pack_gather(
        keys, perm, (x, y, z, h, m), cap, level)
    r2 = jnp.where(valid, (2.0 * ph) ** 2, -1.0)
    return (px, py, pz, ph, jnp.where(valid, pm, 0.0), r2), valid, ovf


def pack_grid(pos, h, m, box, level, cap):
    """ELL grid planes (x, y, z, h, m, r2) of one particle set."""
    planes, valid, ovf = _pack(
        *(jnp.asarray(pos[:, i]) for i in range(3)), jnp.asarray(h),
        jnp.asarray(m), box, level, cap)
    require(not bool(ovf), f"cell capacity {cap} overflows at level {level}")
    return planes, valid


def check_counts(got, want, band, what: str) -> None:
    """got == want except for threshold-band pairs, elementwise."""
    got, want, band = (np.asarray(a).astype(np.int64) for a in (got, want, band))
    diff = np.abs(got - want)
    bad = int(np.count_nonzero(diff > band))
    log(f"[check] {what}: {got.size} values, {int(np.count_nonzero(diff))} "
        f"differ, all within the threshold band: {bad == 0} "
        f"(band pairs {int(band.sum())}, sum {int(got.sum())} vs "
        f"{int(want.sum())})")
    require(bad == 0, f"{what}: {bad} counts differ beyond the threshold band")


def check_density(got, want, what: str) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    ok = err <= DENSITY_RTOL * np.abs(want)
    rel = float(np.max(err / np.maximum(np.abs(want), 1e-300)))
    log(f"[check] {what}: {got.size} values, max relative error {rel:.3g} "
        f"(limit {DENSITY_RTOL:g})")
    require(bool(ok.all()), f"{what}: relative error {rel:.3g} > {DENSITY_RTOL}")


def kernel_cases(pos, h, m, box, level, cap):
    """(name, stencil kwargs, (tgt, cand, cand_mass), target-slot valid
    mask) of the four ops."""
    (px, py, pz, ph, pm, r2), valid = pack_grid(pos, h, m, box, level, cap)
    half = pos.shape[0] // 2
    (ax, ay, az, _, _, ar2), valid_a = pack_grid(
        pos[:half], h[:half], m[:half], box, level, cap)
    (bx, by, bz, _, _, _), _ = pack_grid(
        pos[half:], h[half:], m[half:], box, level, cap)
    own = (px, py, pz)
    return [
        ("count", dict(op="count"), ((px, py, pz, r2), own, None), valid),
        ("density", dict(op="density"), ((px, py, pz, ph), own, None), valid),
        ("density_mass", dict(op="density"), ((px, py, pz, ph), own, pm),
         valid),
        ("cross", dict(op="count", exclude_self=False),
         ((ax, ay, az, ar2), (bx, by, bz), None), valid_a),
    ]


def check_kernels(kernel, n: int, level: int, cap: int, seed: int = 0):
    """Phase 2: each kernel op against the plain XLA stencil."""
    pos = uniform_positions(n, seed)
    h = np.full(n, SYNC_H * (SYNC_N / n) ** (1.0 / 3.0), np.float32)
    m = np.random.default_rng(seed + 1).uniform(0.5, 1.5, n).astype(np.float32)
    box = make_box(0.0, 1.0, boundaries=PERIODIC)
    periodic = (True, True, True)
    for name, kw, args, valid in kernel_cases(pos, h, m, box, level, cap):
        valid = np.asarray(valid)
        def bind(stencil, kw=kw):
            return jax.jit(lambda tgt, cand, mass, lengths: stencil(
                tgt, cand, lengths, periodic, level, cand_mass=mass, **kw))

        plain = bind(stencil_xla)
        args = args + (box.lengths,)
        compiled = timed_compile(f"kernel {name}", bind(kernel), *args)
        got = np.asarray(compiled(*args))[valid]
        want = np.asarray(plain(*args))[valid]
        if kw["op"] == "count":
            tgt = args[0]
            hi = plain((*tgt[:3], tgt[3] * (1 + FLIP_REL) ** 2), *args[1:])
            lo = plain((*tgt[:3], tgt[3] * (1 - FLIP_REL) ** 2), *args[1:])
            band = np.asarray(hi - lo)[valid]
            check_counts(got, want, band, f"kernel {name} vs plain")
        else:
            check_density(got, want, f"kernel {name} vs plain")


# ---------------------------------------------------------------- phase 3
class MainPath:
    """Domain.sync followed by the neighbour counts (op="count") or the
    fused SPH density (op="density"), `steps` steps scanned in one
    program. Like bench.py, every step moves each particle by its own
    random drift of up to 0.2 mean spacings per axis, with the sign
    alternating from step to step, so the density field visits two
    snapshots however long the run. `run()` advances the carried state by
    one program call and returns the last step's outputs in layout
    order."""

    def __init__(self, op, pos, h, mass, level, cap, stencil, steps,
                 bucket=64, seed=1):
        n = pos.shape[0]
        self.op, self.n, self.steps = op, n, steps
        self.stencil = stencil
        self.box = make_box(0.0, 1.0, boundaries=PERIODIC)
        capacity = max(4096, int(3.2 * n / bucket) // 1024 * 1024 + 4096)
        self.domain = Domain(
            rank=0, n_ranks=1, bucket_size=bucket, bucket_size_focus=bucket,
            key_dtype=jnp.uint64, tree_capacity=capacity,
            focus_capacity=capacity,
        )
        dstate = self.domain.init_state(box=self.box, boundaries=(1, 1, 1))
        x, y, z = (jnp.asarray(pos[:, i]) for i in range(3))
        hj, mj = jnp.asarray(h), jnp.asarray(mass)
        drift = jnp.asarray(
            np.random.default_rng(seed).uniform(-0.2, 0.2, (n, 3))
            .astype(np.float32) * np.float32(n ** (-1.0 / 3.0)))
        self.state = (dstate, x, y, z, jnp.float32(1.0))
        domain, box = self.domain, self.box

        def step(state):
            dstate, x, y, z, sgn = state
            x = (x + sgn * drift[:, 0]) % 1.0
            y = (y + sgn * drift[:, 1]) % 1.0
            z = (z + sgn * drift[:, 2]) % 1.0
            if op == "count":
                dstate, res = domain.sync(dstate, x, y, z, hj)
                vals, ovf = cell_list_neighbor_counts(
                    res.keys, res.x, res.y, res.z, res.h, box, level, cap,
                    n_valid=res.end_index)
                ovf = jnp.maximum(res.overflow, ovf.astype(jnp.int32))
                m_out = jnp.zeros_like(res.x)
            else:
                sph = SphState(domain=dstate, x=x, y=y, z=z, h=hj, m=mj,
                               n_local=jnp.int32(n))
                sph, vals, res = sph_density_step(
                    domain, sph, cell_level=level, cell_cap=cap)
                dstate, ovf, m_out = sph.domain, res.overflow, res.properties[0]
            out = (res.x, res.y, res.z, res.h, m_out,
                   vals.astype(jnp.float32), res.start_index, res.end_index)
            return (dstate, x, y, z, -sgn), ovf, res.overflow_detail, out

        def loop(state):
            def one(carry, _):
                state, ovf, det, _ = carry
                state, o, d, out = step(state)
                return (state, jnp.maximum(ovf, o), jnp.maximum(det, d),
                        out), None

            _, _, det0, out0 = jax.eval_shape(step, state)
            zeros = jax.tree_util.tree_map(
                lambda s: jnp.zeros(s.shape, s.dtype), (det0, out0))
            (state, ovf, det, out), _ = jax.lax.scan(
                one, (state, jnp.int32(0)) + zeros, None, length=steps)
            return state, ovf, det, out

        self._loop = jax.jit(loop)
        self._compiled = None

    def compile(self, name: str):
        with stencil_used(self.stencil):
            self._compiled = timed_compile(name, self._loop, self.state)

    def run(self):
        """One program call of the compiled loop; returns (seconds per
        step, last outputs)."""
        fn = self._compiled
        t0 = time.perf_counter()
        self.state, ovf, det, out = jax.block_until_ready(fn(self.state))
        dt = (time.perf_counter() - t0) / self.steps
        require(int(ovf) == 0,
                f"{self.op} main path overflowed: {int(ovf)}; sync capacity "
                f"detail (local, tree, focus, move, treelet, halo, window) "
                f"{np.asarray(det).tolist()}; all zero means the cell cap")
        return dt, out


def time_main_paths(n, h, level, cap, kernel, steps, seed=0,
                    ops=("count", "density")):
    """Phase 3: per-step times of both steps with the kernel and with the
    plain stencil, in turns. Returns the kernel paths' last outputs."""
    pos = uniform_positions(n, seed)
    hs = np.full(n, h, np.float32)
    mass = (np.random.default_rng(seed + 2).uniform(0.5, 1.5, n)
            / n).astype(np.float32)
    card = card_info() if jax.devices()[0].platform == "gpu" else "cpu"
    last = {}
    for op in ops:
        paths = {name: MainPath(op, pos, hs, mass, level, cap, st, steps)
                 for name, st in (("xla", stencil_xla), ("kernel", kernel))}
        for name, path in paths.items():
            path.compile(f"sync+{op} {name} ({steps} steps)")
            path.run()  # first call: the tree and focus converge from scratch
        times = {"xla": [], "kernel": []}
        for name in ("xla", "kernel", "kernel", "xla"):
            dt, out = paths[name].run()
            times[name].append(dt)
            if name == "kernel":
                last[op] = out
        mean = {k: float(np.mean(v)) for k, v in times.items()}
        log(f"[time] sync+{op} at n={n} level={level} cap={cap}: "
            f"xla {[f'{t * 1e3:.3f}' for t in times['xla']]} ms/step, "
            f"kernel {[f'{t * 1e3:.3f}' for t in times['kernel']]} ms/step; "
            f"mean xla {mean['xla'] * 1e3:.3f} kernel "
            f"{mean['kernel'] * 1e3:.3f} ms/step; kernel faster: "
            f"{mean['kernel'] < mean['xla']} [card: {card}]")
    return last


# ---------------------------------------------------------------- phase 4
def _min_image(d):
    return d - np.rint(d)  # periodic unit box


def check_main_path_oracle(last, n_sample: int, seed: int = 3):
    """Counts and densities of the last kernel step on a random subsample
    against float64 brute force over all particles."""
    rng = np.random.default_rng(seed)
    for op in last:
        x, y, z, h, m, vals, start, end = (np.asarray(a) for a in last[op])
        s, e = int(start), int(end)
        X = np.stack([x[s:e], y[s:e], z[s:e]], -1).astype(np.float64)
        H = h[s:e].astype(np.float64)
        M = m[s:e].astype(np.float64)
        got = vals[s:e]
        idx = rng.choice(e - s, size=min(n_sample, e - s), replace=False)
        want = np.empty(idx.size)
        band = np.zeros(idx.size, np.int64)
        for k, i in enumerate(idx):
            # pre-select by the x distance, then the full distance
            R = 2.0 * H[i]
            near = np.abs(_min_image(X[:, 0] - X[i, 0])) < R * (1.0 + 1e-5)
            near[i] = False
            d = _min_image(X[near] - X[i])
            r = np.sqrt((d * d).sum(-1))
            if op == "count":
                want[k] = np.count_nonzero(r < R)
                band[k] = np.count_nonzero(np.abs(r / R - 1.0) < FLIP_REL)
            else:
                q = r / H[i]
                w = np.where(q < 1.0, 1.0 - 1.5 * q * q * (1.0 - 0.5 * q),
                             np.where(q < 2.0, 0.25 * (2.0 - q) ** 3, 0.0))
                want[k] = ((w * M[near]).sum() + M[i]) / (np.pi * H[i] ** 3)
        if op == "count":
            check_counts(got[idx], want, band,
                         f"sync+count, {idx.size} particles vs f64 brute force")
        else:
            check_density(got[idx], want,
                          f"sync+density, {idx.size} particles vs f64 formula")


def check_octree(n: int, bucket: int, seed: int = 42, reps: int = 3):
    """The 2M-key build (bench.py main_tree's sample) and one update:
    cornerstone invariants, and the build bit-exact against the native
    host build."""
    rng = np.random.RandomState(seed)
    pos = np.clip(rng.normal(0.5, 0.15, size=(n, 3)), 0.0, 1.0 - 1e-6)
    pos = pos.astype(np.float32)
    drift = rng.uniform(-0.2, 0.2, size=(n, 3)).astype(np.float32)
    pos2 = np.clip(pos + drift * n ** (-1.0 / 3.0), 0.0, 1.0 - 1e-6)
    box = make_box(0.0, 1.0, boundaries=PERIODIC)

    @jax.jit
    def sorted_keys(p):
        k = compute_sfc_keys(p[:, 0], p[:, 1], p[:, 2], box, jnp.uint64)
        return jnp.sort(k)

    keys = sorted_keys(jnp.asarray(pos))
    keys2 = sorted_keys(jnp.asarray(pos2.astype(np.float32)))
    capacity = max(4096, int(3.2 * n / bucket) // 1024 * 1024 + 4096)
    init = default_init_level(n, bucket, capacity)
    build = timed_compile(
        "octree build", jax.jit(lambda k: _compute_octree_jit(
            k, bucket, capacity, MAX_UINT32, None, init)), keys)
    tree = build(keys)
    update = timed_compile(
        "octree update", jax.jit(lambda t, k: update_octree(
            t, k, bucket, MAX_UINT32, None)), tree, keys2)
    tb, tu = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        tree = jax.block_until_ready(build(keys))
        tb.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        tree2, _ = jax.block_until_ready(update(tree, keys2))
        tu.append(time.perf_counter() - t0)
    n_nodes = int(tree.n_nodes)
    log(f"[time] octree n={n} bucket={bucket}: nodes {n_nodes}, build "
        f"{[f'{t * 1e3:.3f}' for t in tb]} ms, update "
        f"{[f'{t * 1e3:.3f}' for t in tu]} ms")
    require(n_nodes <= capacity, f"octree capacity {capacity} exceeded")
    for name, t in (("build", tree), ("update", tree2)):
        nn = int(t.n_nodes)
        tk = np.asarray(t.keys[: nn + 1])
        tc = np.asarray(t.counts[:nn]).astype(np.int64)
        d = np.diff(tk)
        pow8 = (d > 0) & ((d & (d - np.uint64(1))) == 0)
        pow8 &= (np.log2(np.maximum(d, 1).astype(np.float64)) % 3) == 0
        require(tk[0] == 0 and tk[-1] == np.uint64(1) << np.uint64(63),
                f"octree {name}: wrong key range")
        require(bool(pow8.all()), f"octree {name}: node ranges not 8^k")
        require(int(tc.sum()) == n, f"octree {name}: counts sum {tc.sum()}")
    require(int(np.asarray(tree.counts[:n_nodes]).max()) <= bucket,
            "octree build: a leaf holds more than the bucket")
    host_keys, host_counts = native.compute_octree_host(
        np.asarray(keys), bucket, capacity)
    require(np.array_equal(host_keys, np.asarray(tree.keys[: n_nodes + 1]))
            and np.array_equal(host_counts, np.asarray(tree.counts[:n_nodes])),
            "octree build differs from the native host build")
    log(f"[check] octree build and update: cornerstone invariants hold; "
        f"build equals the native host build ({n_nodes} nodes)")


# ---------------------------------------------------------------- phase 5
def tree_counts(x, y, z, h, box, bucket=64, group_size=64, cand_leaf_cap=512,
                cand_cap=8192, frontier_cap=512, chunk=32, public=False):
    """Tree-path neighbour counts (the traversal oracle), capacities
    doubled until nothing overflows. public=True goes through
    find_neighbors."""
    n = x.shape[0]
    keys = compute_sfc_keys(x, y, z, box, jnp.uint64)
    order = jnp.argsort(keys)
    keys, x, y, z, h = keys[order], x[order], y[order], z[order], h[order]
    capacity = max(4096, int(3.2 * n / bucket) // 1024 * 1024 + 4096)
    tree = _compute_octree_jit(keys, bucket, capacity, MAX_UINT32, None,
                               default_init_level(n, bucket, capacity))
    linked = build_linked_octree(tree.keys, tree.n_nodes)
    view = make_ns_view(linked, leaf_layout_from_counts(tree.counts), box)
    for _ in range(4):
        if public:
            counts, _ = find_neighbors(
                x, y, z, h, view, box, group_size=group_size,
                cand_leaf_cap=cand_leaf_cap, cand_cap=cand_cap, chunk=chunk,
                frontier_cap=frontier_cap)
            break
        counts, _, st = _find_neighbors_impl(
            x, y, z, h, view, box, 1, group_size, cand_leaf_cap, cand_cap,
            chunk, False, n, frontier_cap=frontier_cap)
        if (int(st.leaf_max) <= cand_leaf_cap and int(st.cand_max) <= cand_cap
                and int(st.frontier_max) <= frontier_cap):
            break
        cand_leaf_cap, cand_cap, frontier_cap = (
            2 * cand_leaf_cap, 2 * cand_cap, 2 * frontier_cap)
    else:
        raise SmokeFailure("tree path still overflows")
    inv = jnp.argsort(order)
    return np.asarray(counts[inv]), (cand_leaf_cap, cand_cap, frontier_cap)


def check_reach(n: int, seed: int = 42):
    """The tiered adaptive-h cell list (with choose_stencil()'s stencil)
    on a box-truncated Plummer sphere against the tree path;
    find_neighbors once."""
    pos = truncated_plummer_coords(n, scale=0.25, seed=seed)
    h = adaptive_h(pos, (0.0, 1.0) * 3, 100.0)
    box = make_box(0.0, 1.0)  # open boundaries: an isolated cluster
    x, y, z = (jnp.asarray(pos[:, i]) for i in range(3))
    hj = jnp.asarray(h)
    keys = compute_sfc_keys(x, y, z, box, jnp.uint64)
    order = np.asarray(jnp.argsort(keys))
    levels = choose_tier_levels(h, 1.0, max_tiers=3)
    caps, cross = tier_caps(pos[order], h[order], (0.0, 1.0), levels,
                            slack=1.3)
    tiered = jax.jit(partial(
        cell_list_neighbor_counts_tiered, box=box, levels=levels, caps=caps,
        cross_caps=cross))
    args = (keys[order], x[order], y[order], z[order], hj[order])
    compiled = timed_compile("tiered counts", tiered, *args)
    t0 = time.perf_counter()
    got_s, ovf = jax.block_until_ready(compiled(*args))
    t_tiered = time.perf_counter() - t0
    require(not bool(ovf), "tiered cell list overflowed")
    got = np.empty(n, np.int64)
    got[order] = np.asarray(got_s)
    want, caps_used = tree_counts(x, y, z, hj, box)
    hi, _ = tree_counts(x, y, z, hj * (1 + FLIP_REL), box)
    lo, _ = tree_counts(x, y, z, hj * (1 - FLIP_REL), box)
    log(f"[reach] Plummer n={n}: tier levels {levels}, caps {caps}, cross "
        f"{cross}, tiered run {t_tiered * 1e3:.3f} ms; tree caps "
        f"(leaf, cand, frontier) {caps_used}")
    check_counts(got, want, hi - lo, "tiered vs tree path")
    pub, _ = tree_counts(x, y, z, hj, box, public=True,
                         cand_leaf_cap=caps_used[0], cand_cap=caps_used[1],
                         frontier_cap=caps_used[2])
    require(np.array_equal(pub, want), "find_neighbors differs from the tree path")
    log(f"[check] find_neighbors(with_indices=False): {n} counts equal the "
        f"tree path")


# ---------------------------------------------------------------- phase 6
def check_multichip(n_ranks: int, n_per: int, seed: int = 5,
                    protocols=("dense", "ragged")):
    """Domain.sync under shard_map over n_ranks devices; the psum of the
    owned cell-list counts must equal the single-device sum over the same
    particles."""
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    from cstone_tpu.parallel import make_mesh, rank_axis
    from cstone_tpu.parallel.ragged import use_native_ragged

    n = n_ranks * n_per
    h = SYNC_H * (SYNC_N / n) ** (1.0 / 3.0)
    box = make_box(0.0, 1.0, boundaries=PERIODIC)
    level = choose_cell_level(box, h)
    cap = default_cell_cap(n, level)
    pos = uniform_positions(n, seed)
    x, y, z = (jnp.asarray(pos[:, i]) for i in range(3))
    hs = jnp.full((n,), np.float32(h))

    keys = compute_sfc_keys(x, y, z, box, jnp.uint64)
    ref = jax.jit(lambda k, x, y, z, h: cell_list_neighbor_counts(
        *jax.lax.sort((k, x, y, z, h), num_keys=1), box, level, cap))
    counts, ovf = ref(keys, x, y, z, hs)
    require(not bool(ovf), "single-device reference overflowed")
    expected = int(np.asarray(counts).astype(np.int64).sum())

    mesh = make_mesh(n_ranks)
    sharding = NamedSharding(mesh, P(rank_axis))
    bucket = 64
    caps = {}
    for protocol in protocols:
        def run(caps):
            local = caps.get("local", 2 * n_per)
            tree_cap = caps.get("tree", max(4096, int(3.2 * n / bucket) // 1024 * 1024 + 4096))
            buf = np.zeros((n_ranks, local, 4), np.float32)
            buf[:, :n_per, :3] = pos.reshape(n_ranks, n_per, 3)
            buf[:, :n_per, 3] = h
            xl, yl, zl, hl = (jax.device_put(
                jnp.asarray(buf[..., i].reshape(-1)), sharding)
                for i in range(4))
            dom_caps = {k: caps[k] for k in ("move", "treelet", "halo")
                        if k in caps}

            def step(xl, yl, zl, hl):
                domain = Domain(
                    rank=jax.lax.axis_index(rank_axis), n_ranks=n_ranks,
                    bucket_size=bucket, bucket_size_focus=bucket,
                    key_dtype=jnp.uint64, tree_capacity=tree_cap,
                    focus_capacity=caps.get("focus", tree_cap),
                    axis_name=rank_axis, protocol=protocol,
                    move_cap=dom_caps.get("move", 0),
                    treelet_cap=dom_caps.get("treelet", 0),
                    halo_req_cap=dom_caps.get("halo", 0),
                    halo_cap=dom_caps.get("halo", 0),
                )
                state = domain.init_state(box=box, boundaries=(1, 1, 1))
                state, res = domain.sync(state, xl, yl, zl, hl,
                                         n_local=jnp.int32(n_per))
                c, c_ovf = cell_list_neighbor_counts(
                    res.keys, res.x, res.y, res.z, res.h, box, level, cap,
                    n_valid=res.n_with_halos)
                j = jnp.arange(c.shape[0], dtype=jnp.int32)
                owned = (j >= res.start_index) & (j < res.end_index)
                total = jax.lax.psum(
                    jnp.sum(jnp.where(owned, c.astype(jnp.int64), 0)),
                    rank_axis)
                n_owned = jax.lax.psum(
                    (res.end_index - res.start_index).astype(jnp.int64),
                    rank_axis)
                ovf = jax.lax.pmax(
                    jnp.maximum(res.overflow, c_ovf.astype(jnp.int32)),
                    rank_axis)
                return total, n_owned, ovf, res.overflow_detail

            fn = jax.jit(shard_map(
                step, mesh=mesh, in_specs=(P(rank_axis),) * 4,
                out_specs=(P(), P(), P(), P()), check_vma=False))
            t0 = time.perf_counter()
            total, n_owned, ovf, detail = jax.block_until_ready(
                fn(xl, yl, zl, hl))
            log(f"[multichip] {protocol}: caps {caps}, call "
                f"{time.perf_counter() - t0:.1f} s (compile included)")
            res = _MultiResult(total, n_owned, ovf, detail)
            return res

        out, grown = sync_with_retry(run, caps)
        # the next protocol starts from the protocol-independent capacities
        # this one grew to (the p2p caps mean lanes for dense, totals for
        # ragged)
        caps = {k: grown[k] for k in ("local", "tree", "focus") if k in grown}
        require(int(out.n_owned) == n, f"{protocol}: owned {int(out.n_owned)} != {n}")
        got = int(out.total)
        via = ""
        if protocol == "ragged":
            via = (" (native ragged_all_to_all)" if use_native_ragged()
                   else " (emulated ragged_all_to_all)")
        log(f"[check] {protocol} protocol{via} on {n_ranks} devices: psum of "
            f"owned counts {got}, single-device sum {expected}, equal: "
            f"{got == expected}")
        require(got == expected, f"{protocol}: neighbour sum {got} != {expected}")


class _MultiResult:
    """The fields sync_with_retry reads (overflow, overflow_detail)."""

    def __init__(self, total, n_owned, overflow, detail):
        self.total, self.n_owned = total, n_owned
        self.overflow, self.overflow_detail = overflow, detail


# ---------------------------------------------------------------- driver
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card distributed Domain phase")
    args = ap.parse_args(argv)

    COMPILE_SECONDS.clear()
    devices = require_gpu(args.chips)
    card = card_info()
    log(f"[device] {card}")
    configure_compile_cache()
    t_start = time.perf_counter()
    if args.chips == 4:
        check_multichip(4, SYNC_N)
    else:
        box = make_box(0.0, 1.0, boundaries=PERIODIC)
        level = choose_cell_level(box, SYNC_H)
        cap = default_cell_cap(SYNC_N, level, snapshots=3)
        log(f"[config] sync_1M_uniform: n={SYNC_N} h={SYNC_H} level={level} "
            f"cap={cap} steps={SYNC_STEPS}")
        check_kernels(stencil_pallas, SYNC_N, level, cap)
        last = time_main_paths(SYNC_N, SYNC_H, level, cap, stencil_pallas,
                               SYNC_STEPS)
        check_main_path_oracle(last, ORACLE_SAMPLE)
        check_octree(TREE_N, TREE_BUCKET)
        check_reach(REACH_N)
    stats = devices[0].memory_stats() or {}
    log(f"[memory] device 0 peak_bytes_in_use: "
        f"{stats.get('peak_bytes_in_use', 'not reported')}")
    log(f"[compile] total {sum(COMPILE_SECONDS.values()):.1f} s over "
        f"{len(COMPILE_SECONDS)} programs; wall {time.perf_counter() - t_start:.1f} s")
    log(f"[device] {card}")
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": args.chips}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
