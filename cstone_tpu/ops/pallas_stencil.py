"""Pallas kernel (Triton route) for the 27-point cell-list stencil.

Dense companion to traversal/celllist.py, which packs SFC-sorted
particles into an ELL grid: (n_cells, cap) planes in row-major cell
order, empty slots holding INVALID_COORD. One program handles one target
cell. It loads the cell's targets once, walks the 27 neighbour cells,
loads each neighbour's candidate row and adds a (cap_t, cap_c) tile of
pair terms in registers; one row reduction at the end writes the
target-side sums. The periodic wrap is applied per neighbour offset (+-L
on the wrapped axis), open boundaries mask the out-of-range neighbours,
so no ghost-cell copy and no neighbour-index list reaches device memory
(the reference applies its per-pair op inside the warp traversal the
same way, find_neighbors.cuh:94-124).

Contract, shared with the plain reference celllist.stencil_xla:
  op="count":   out_i = sum_j [d2_ij < r2_i]       tgt param plane = r2
                                                   (< 0 marks an empty slot)
  op="density": out_i = sum_j m_j W(|r_ij| / h_i)  tgt param plane = h
                (m_j = 1 without a mass plane; W the unnormalised cubic
                spline)
exclude_self=True means targets and candidates are the same pack, and
drops the j == i slot pair of the centre cell (coincident distinct
particles still count each other, like the reference's i != j rule).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from .primitives import cubic_spline_w

__all__ = ["INVALID_COORD", "stencil_pallas"]

INVALID_COORD = np.float32(1e30)

# Launch shape: each program takes up to BLOCK targets of one cell and
# walks the neighbour cells' candidates BLOCK at a time, so the register
# tile stays (BLOCK, BLOCK) at any capacity. These were the fastest of
# 2/4/8 warps x 1/2/3 stages on an H100 at 1M particles, level 5, cap 64.
BLOCK = 64
NUM_WARPS = 8
NUM_STAGES = 2


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _kernel(
    len_ref,  # (4,) box lengths (x, y, z, unused)
    tx_ref, ty_ref, tz_ref, tp_ref,  # (n_cells*cap_t,) targets; tp = r2|h
    cx_ref, cy_ref, cz_ref,  # (n_cells*cap_c,) candidates
    *rest,  # [cm_ref (n_cells*cap_c,) candidate mass], out_ref
    D: int,
    cap_t: int,
    cap_c: int,
    bt: int,
    bc: int,
    periodic: Tuple[bool, bool, bool],
    op: str,
    exclude_self: bool,
):
    cm_ref = rest[0] if len(rest) == 2 else None
    out_ref = rest[-1]
    f32 = jnp.float32
    c = pl.program_id(0)  # target cell
    tblk = pl.program_id(1)  # block of bt target slots within the cell
    n_cb = cap_c // bc  # candidate blocks per neighbour cell
    cell = (c // (D * D), (c // D) % D, c % D)
    lengths = (len_ref[0], len_ref[1], len_ref[2])

    tb = pl.multiple_of(c * cap_t + tblk * bt, bt)
    tx = tx_ref[pl.ds(tb, bt)][:, None]
    ty = ty_ref[pl.ds(tb, bt)][:, None]
    tz = tz_ref[pl.ds(tb, bt)][:, None]
    tp = tp_ref[pl.ds(tb, bt)][:, None]
    if op == "density":
        inv_h = 1.0 / tp  # empty slots: h = 1e30 -> ~0, W(inf) = 0
    if exclude_self:
        t_slot = tblk * bt + jax.lax.broadcasted_iota(jnp.int32, (bt, bc), 0)
        c_lane = jax.lax.broadcasted_iota(jnp.int32, (bt, bc), 1)

    def body(k, acc):
        nbr = k // n_cb  # neighbour offset index 0..26; 13 is the centre
        cblk = k % n_cb
        offs = (nbr // 9 - 1, (nbr // 3) % 3 - 1, nbr % 3 - 1)
        nb = []  # wrapped neighbour coordinate per axis
        wrap = []  # -1/0/+1 when the neighbour crosses the low/high face
        ok = True
        for axis in range(3):
            n = cell[axis] + offs[axis]
            o = (n + D) // D - 1
            nb.append(n - o * D)
            wrap.append(o)
            if not periodic[axis]:
                ok = ok & (o == 0)
        nc = (nb[0] * D + nb[1]) * D + nb[2]
        cb = pl.multiple_of(nc * cap_c + cblk * bc, bc)
        cand = []
        for axis, ref in enumerate((cx_ref, cy_ref, cz_ref)):
            v = ref[pl.ds(cb, bc)]
            if periodic[axis]:
                v = v + wrap[axis].astype(f32) * lengths[axis]
            cand.append(v[None, :])
        ddx = tx - cand[0]
        ddy = ty - cand[1]
        ddz = tz - cand[2]
        d2 = ddx * ddx + ddy * ddy + ddz * ddz
        if op == "count":
            term = (d2 < tp).astype(f32)
        else:
            term = cubic_spline_w(jnp.sqrt(d2) * inv_h)
            if cm_ref is not None:
                term = term * cm_ref[pl.ds(cb, bc)][None, :]
        keep = ok
        if exclude_self:
            keep = keep & ~((nbr == 13) & (t_slot == cblk * bc + c_lane))
        if keep is True:
            return acc + term
        return acc + jnp.where(keep, term, f32(0.0))

    acc = jax.lax.fori_loop(
        jnp.int32(0), jnp.int32(27 * n_cb), body, jnp.zeros((bt, bc), f32)
    )
    tot = jnp.sum(acc, axis=1)
    out_ref[pl.ds(tb, bt)] = tot.astype(jnp.int32) if op == "count" else tot


@partial(jax.jit, static_argnames=(
    "D", "cap_t", "cap_c", "periodic", "op", "exclude_self", "interpret"))
def _call(lengths4, tgt, cand, cand_mass, *, D, cap_t, cap_c, periodic, op,
          exclude_self, interpret):
    n_cells = D * D * D
    out_dtype = jnp.int32 if op == "count" else jnp.float32
    args = (lengths4, *tgt, *cand) + (() if cand_mass is None else (cand_mass,))
    bt, bc = min(cap_t, BLOCK), min(cap_c, BLOCK)
    return pl.pallas_call(
        partial(_kernel, D=D, cap_t=cap_t, cap_c=cap_c, bt=bt, bc=bc,
                periodic=periodic, op=op, exclude_self=exclude_self),
        out_shape=jax.ShapeDtypeStruct((n_cells * cap_t,), out_dtype),
        grid=(n_cells, cap_t // bt),
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES),
        interpret=interpret,
        name=f"cell_stencil_{op}",
    )(*args)


def stencil_pallas(
    tgt: Sequence[jax.Array],  # (tx, ty, tz, r2|h), each (n_cells, cap_t)
    cand: Sequence[jax.Array],  # (cx, cy, cz), each (n_cells, cap_c)
    lengths,  # (3,) box lengths
    periodic: Tuple[bool, bool, bool],
    level: int,
    op: str = "count",
    exclude_self: bool = True,
    cand_mass: Optional[jax.Array] = None,  # (n_cells, cap_c), 0 in empties
    *,
    interpret: bool = False,
) -> jax.Array:
    """(n_cells, cap_t) target-side stencil sums on the Triton route:
    int32 counts for op="count", float32 sums for op="density".

    Both capacities are padded to powers of two (Triton block shapes);
    padded target slots are empty (r2 = -1, h = 1e30), padded candidate
    slots sit at INVALID_COORD with zero mass; capacities above BLOCK are
    walked in BLOCK-wide tiles. The grid must be at least 4 cells per dim
    (level >= 2) so the 27 neighbours are distinct.
    """
    if op not in ("count", "density"):
        raise ValueError(f"unknown stencil op {op!r}")
    D = 1 << int(level)
    tx, ty, tz, tp = tgt
    n_cells, cap_t = tx.shape
    cap_c = cand[0].shape[1]
    if exclude_self and cap_t != cap_c:
        raise ValueError("exclude_self needs targets and candidates from one pack")
    pt, pc = _next_pow2(cap_t), _next_pow2(cap_c)

    def pad(a, width, fill):
        a = a.astype(jnp.float32)
        if width > a.shape[1]:
            a = jnp.pad(a, ((0, 0), (0, width - a.shape[1])),
                        constant_values=fill)
        return a.reshape(-1)

    tp_fill = -1.0 if op == "count" else float(INVALID_COORD)
    tgt_f = tuple(pad(a, pt, INVALID_COORD) for a in (tx, ty, tz)) + (
        pad(tp, pt, tp_fill),)
    cand_f = tuple(pad(a, pc, INVALID_COORD) for a in cand)
    mass_f = None if cand_mass is None else pad(cand_mass, pc, 0.0)
    lengths4 = jnp.concatenate(
        [jnp.asarray(lengths, jnp.float32).reshape(3),
         jnp.zeros((1,), jnp.float32)])
    out = _call(
        lengths4, tgt_f, cand_f, mass_f, D=D, cap_t=pt, cap_c=pc,
        periodic=tuple(bool(p) for p in periodic), op=op,
        exclude_self=bool(exclude_self), interpret=bool(interpret),
    )
    return out.reshape(n_cells, pt)[:, :cap_t]
