"""Barnes-Hut monopole gravity on the linked octree.

Demo client for the syncGrav path (the reference's gravity client is
SPH-EXA/ryoanji; cornerstone itself provides the tree + MAC machinery,
reference: include/cstone/traversal/macs.hpp, focus/source_center.hpp).

JAX design: like the neighbor search, targets are SFC-compact
particle groups. Each group runs one batched MAC traversal: nodes passing
the vector MAC against the group's bounding box contribute their monopole
(mass at center-of-mass); failing leaves are collected for dense
particle-particle interaction — a dense (targets x sources) tile.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..sfc.box import Box
from ..traversal.boxoverlap import min_distance_point_box
from ..traversal.traversal import batched_collect_leaves
from ..tree.octree import LinkedOctree

__all__ = ["gravity_monopole"]


@partial(
    jax.jit,
    static_argnames=("group_size", "leaf_cap", "cand_cap", "chunk", "n_targets"),
)
def gravity_monopole(
    x: jax.Array,
    y: jax.Array,
    z: jax.Array,
    m: jax.Array,
    tree: LinkedOctree,
    layout: jax.Array,
    centers: jax.Array,  # (cap_nodes, 4) mass centers (x,y,z,m)
    mac_sq: jax.Array,  # (cap_nodes,) squared vec-MAC radius per node
    geo_centers: jax.Array,
    geo_sizes: jax.Array,
    box: Box,
    G: float = 1.0,
    eps2: float = 1e-8,
    group_size: int = 64,
    leaf_cap: int = 256,
    cand_cap: int = 4096,
    chunk: int = 16,
    n_targets: int = 0,
):
    """Accelerations (ax, ay, az) for SFC-sorted local particles.

    Approximation: nodes whose vector MAC passes w.r.t. the whole target
    group contribute as monopoles; all other mass is accumulated through
    opened leaves particle-by-particle. Accuracy is governed by theta used
    to build mac_sq (macs.hpp:73-97).
    """
    n = n_targets or x.shape[0]
    fdt = x.dtype
    n_groups = -(-n // group_size)
    cap_nodes = tree.prefixes.shape[0]
    cap_leaf = tree.leaves.shape[0] - 1

    # group bounding boxes
    pad = n_groups * group_size - n
    def pad1(a):
        return jnp.concatenate([a[:n], jnp.zeros((pad,), a.dtype)]) if pad else a[:n]

    gx = pad1(x).reshape(n_groups, group_size)
    gy = pad1(y).reshape(n_groups, group_size)
    gz = pad1(z).reshape(n_groups, group_size)
    lane = jnp.arange(group_size, dtype=jnp.int32)
    gvalid = (jnp.arange(n_groups, dtype=jnp.int32)[:, None] * group_size + lane) < n
    big = fdt.type(np.finfo(fdt).max)
    gmin = jnp.stack(
        [jnp.min(jnp.where(gvalid, a, big), 1) for a in (gx, gy, gz)], -1
    )
    gmax = jnp.stack(
        [jnp.max(jnp.where(gvalid, a, -big), 1) for a in (gx, gy, gz)], -1
    )
    g_center = (gmin + gmax) * fdt.type(0.5)
    g_size = (gmax - gmin) * fdt.type(0.5)

    src_center = centers[:, :3]

    # traversal: descend while the vector MAC FAILS for the group box;
    # endpoints are leaves needing P2P. Nodes where the MAC passes
    # contribute monopoles — accumulated via a second mark-style pass below.
    def mac_fails(q_ids, node_ids):
        d = min_distance_point_box(
            src_center[node_ids], g_center[q_ids], g_size[q_ids], box
        )
        r2 = jnp.sum(d * d, axis=-1)
        return r2 < mac_sq[node_ids]

    p2p_leaves, n_p2p = batched_collect_leaves(
        tree.child_offsets, mac_fails, n_groups, leaf_cap
    )

    # monopole accumulation: traverse again, but accumulate accepted
    # children (MAC passes) per group. Reuse the DFS: for every node popped
    # (which failed the MAC), children either fail (push/emit) or pass
    # (monopole). Here we recompute accepted children from p2p traversal
    # structure: a node contributes a monopole iff its MAC passes and its
    # parent's fails. Vectorized per (group, node) would be O(G*N); instead
    # accumulate during a second lockstep walk.
    def monopole_walk(gc, gs, gxi, gyi, gzi, gval):
        # per single group: while-loop DFS accumulating monopole forces on
        # the group's particles; vmapped over groups.
        stack = jnp.zeros((128,), jnp.int32)
        ax = jnp.zeros((group_size,), fdt)
        ay = jnp.zeros((group_size,), fdt)
        az = jnp.zeros((group_size,), fdt)

        def fails(nid):
            d = min_distance_point_box(src_center[nid], gc, gs, box)
            return jnp.sum(d * d) < mac_sq[nid]

        root_fail = fails(0)
        pos = jnp.where(root_fail & (tree.child_offsets[0] > 0), 1, 0)

        def add_monopole(nid, ax, ay, az):
            cm = centers[nid]
            dx = cm[0] - gxi
            dy = cm[1] - gyi
            dz = cm[2] - gzi
            if any(b == 1 for b in box.boundaries):
                L = box.lengths.astype(fdt)
                iL = (1.0 / box.lengths).astype(fdt)
                pm = jnp.asarray(box.periodic_mask, fdt)
                dx = dx - pm[0] * L[0] * jnp.round(dx * iL[0])
                dy = dy - pm[1] * L[1] * jnp.round(dy * iL[1])
                dz = dz - pm[2] * L[2] * jnp.round(dz * iL[2])
            r2 = dx * dx + dy * dy + dz * dz + fdt.type(eps2)
            inv_r3 = jax.lax.rsqrt(r2) / r2
            w = fdt.type(G) * jnp.abs(cm[3]) * inv_r3
            return ax + w * dx, ay + w * dy, az + w * dz

        def body(state):
            stack, pos, ax, ay, az = state
            node = stack[jnp.maximum(pos - 1, 0)]
            pos = pos - 1
            c0 = tree.child_offsets[node]
            out = (stack, pos, ax, ay, az)

            def handle(k, st):
                stack, pos, ax, ay, az = st
                child = jnp.minimum(c0 + k, cap_nodes - 1)
                f = fails(child)
                is_leaf = tree.child_offsets[child] == 0
                # MAC passes -> monopole
                nax, nay, naz = add_monopole(child, ax, ay, az)
                ax2 = jnp.where(~f, nax, ax)
                ay2 = jnp.where(~f, nay, ay)
                az2 = jnp.where(~f, naz, az)
                # MAC fails + internal -> push (leaves handled in P2P pass)
                do_push = f & (~is_leaf)
                stack = stack.at[jnp.minimum(pos, 127)].set(
                    jnp.where(do_push, child, stack[jnp.minimum(pos, 127)])
                )
                pos = pos + do_push.astype(jnp.int32)
                return stack, pos, ax2, ay2, az2

            out = jax.lax.fori_loop(0, 8, handle, out)
            return out

        def cond(state):
            _, pos, _, _, _ = state
            return pos > 0

        stack, pos, ax, ay, az = jax.lax.while_loop(
            cond, body, (stack, pos, ax, ay, az)
        )
        # root passes MAC entirely (tiny systems): single monopole
        ax, ay, az = jax.lax.cond(
            root_fail,
            lambda t: t,
            lambda t: add_monopole(0, *t),
            (ax, ay, az),
        )
        return ax, ay, az

    axg, ayg, azg = jax.vmap(monopole_walk)(g_center, g_size, gx, gy, gz, gvalid)

    # ---- P2P from collected leaves -----------------------------------------
    leaf_idx = tree.internal_to_leaf[jnp.maximum(p2p_leaves, 0)]
    leaf_idx = jnp.where(p2p_leaves >= 0, leaf_idx, 0)
    k = jnp.arange(leaf_cap, dtype=jnp.int32)
    k_valid = k[None, :] < jnp.minimum(n_p2p, leaf_cap)[:, None]
    starts = layout[leaf_idx]
    lens = jnp.where(k_valid, layout[leaf_idx + 1] - starts, 0)
    inc = jnp.cumsum(lens, axis=1)
    total = inc[:, -1]
    jj = jnp.arange(cand_cap, dtype=jnp.int32)
    seg = jax.vmap(lambda row: jnp.searchsorted(row, jj, side="right"))(inc)
    seg = jnp.minimum(seg.astype(jnp.int32), leaf_cap - 1)
    row_q = jnp.arange(n_groups, dtype=jnp.int32)[:, None]
    exc = inc[row_q, seg] - lens[row_q, seg]
    cand = starts[row_q, seg] + (jj[None, :] - exc)
    cand_ok = jj[None, :] < jnp.minimum(total, cand_cap)[:, None]
    cand = jnp.where(cand_ok, cand, 0)

    n_chunks = -(-n_groups // chunk)
    padg = n_chunks * chunk

    def padrows(a, fill=0):
        p = padg - a.shape[0]
        if p:
            a = jnp.concatenate([a, jnp.full((p,) + a.shape[1:], fill, a.dtype)])
        return a

    cand_p = padrows(cand)
    cand_ok_p = padrows(cand_ok.astype(jnp.bool_))
    gx_p, gy_p, gz_p = padrows(gx), padrows(gy), padrows(gz)
    gv_p = padrows(gvalid.astype(jnp.bool_))

    pm = jnp.asarray(box.periodic_mask, fdt)
    L = box.lengths.astype(fdt)
    iL = (1.0 / box.lengths).astype(fdt)
    any_pbc = any(b == 1 for b in box.boundaries)

    def do_chunk(c):
        s = c * chunk
        ci = jax.lax.dynamic_slice_in_dim(cand_p, s, chunk)
        cv = jax.lax.dynamic_slice_in_dim(cand_ok_p, s, chunk)
        txs = jax.lax.dynamic_slice_in_dim(gx_p, s, chunk)
        tys = jax.lax.dynamic_slice_in_dim(gy_p, s, chunk)
        tzs = jax.lax.dynamic_slice_in_dim(gz_p, s, chunk)
        tv = jax.lax.dynamic_slice_in_dim(gv_p, s, chunk)

        cxs, cys, czs, cms = x[ci], y[ci], z[ci], m[ci]

        def axis_d(t, cc, dim):
            d = cc[:, None, :] - t[:, :, None]
            if any_pbc:
                d = d - pm[dim] * L[dim] * jnp.round(d * iL[dim])
            return d

        dx = axis_d(txs, cxs, 0)
        dy = axis_d(tys, cys, 1)
        dz = axis_d(tzs, czs, 2)
        tgt_idx = (jnp.arange(chunk, dtype=jnp.int32)[:, None] + s) * group_size + lane
        not_self = ci[:, None, :] != tgt_idx[:, :, None]
        r2 = dx * dx + dy * dy + dz * dz + fdt.type(eps2)
        inv_r3 = jax.lax.rsqrt(r2) / r2
        w = jnp.where(
            not_self & cv[:, None, :] & tv[:, :, None],
            fdt.type(G) * cms[:, None, :] * inv_r3,
            0.0,
        )
        return jnp.sum(w * dx, -1), jnp.sum(w * dy, -1), jnp.sum(w * dz, -1)

    pax, pay, paz = jax.lax.map(do_chunk, jnp.arange(n_chunks, dtype=jnp.int32))
    overflow = jnp.max(jnp.where(total > cand_cap, total, 0))

    def fin(a_mono, a_p2p):
        a = a_mono + a_p2p.reshape(padg, group_size)[:n_groups]
        return a.reshape(-1)[:n]

    return fin(axg, pax), fin(ayg, pay), fin(azg, paz), overflow
