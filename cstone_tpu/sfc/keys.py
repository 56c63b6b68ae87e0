"""Key-generic SFC operations, independent of the curve type.

Vectorized JAX re-design of the reference's key math
(reference: include/cstone/sfc/common.hpp). All functions operate
elementwise on jnp arrays of dtype uint32 or uint64 and are jit-safe.

Key layout (identical to the reference, tree/definitions.h:45-97):
  - uint32 keys: 10 octree levels, 30 used bits, 2 unused leading bits
  - uint64 keys: 21 octree levels, 63 used bits, 1 unused leading bit
  - removeKey sentinel = 2^(3*maxLevel) flags particles for removal
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.bits import count_leading_zeros, count_trailing_zeros

__all__ = [
    "max_tree_level",
    "unused_bits",
    "max_coord",
    "node_range",
    "remove_key",
    "to_nbit_int",
    "to_nbit_int_ceil",
    "pad_prefix",
    "log8_ceil",
    "is_power_of_8",
    "common_prefix",
    "tree_level",
    "encode_placeholder_bit",
    "encode_placeholder_bit_2k",
    "decode_prefix_length",
    "decode_placeholder_bit",
    "mask_key",
    "unmask_key",
    "is_masked",
    "octal_digit",
    "is_ancestor",
    "digit_weight",
    "enclosing_box_code",
    "smallest_common_box",
    "zero_low_bits",
    "last_nz_place",
    "make_prefix",
    "octal_power",
    "span_sfc_range_count",
    "span_sfc_range",
]


# ----------------------------------------------------------------------------
# static per-dtype constants (resolved at trace time)
# ----------------------------------------------------------------------------

def _canon(dtype) -> np.dtype:
    dt = np.dtype(dtype)
    if dt not in (np.dtype(np.uint32), np.dtype(np.uint64)):
        raise TypeError(f"SFC keys must be uint32 or uint64, got {dt}")
    return dt


def max_tree_level(dtype) -> int:
    """10 for uint32 keys, 21 for uint64 keys (definitions.h:66-83)."""
    return 10 if _canon(dtype) == np.dtype(np.uint32) else 21


def unused_bits(dtype) -> int:
    """2 unused leading bits in 32-bit keys, 1 in 64-bit (definitions.h:45-64)."""
    return 2 if _canon(dtype) == np.dtype(np.uint32) else 1


def max_coord(dtype) -> int:
    """Number of integer coordinates per dimension: 2^maxLevel."""
    return 1 << max_tree_level(dtype)


def node_range(dtype, level) -> jax.Array:
    """Key range of one octree node at `level` (common.hpp:125-132).

    `level` may be a python int or a traced int array.
    """
    dt = _canon(dtype)
    lmax = max_tree_level(dt)
    if isinstance(level, (int, np.integer)):
        return jnp.asarray(1 << (3 * (lmax - int(level))), dtype=dt)
    one = jnp.asarray(1, dtype=dt)
    shift = (3 * (lmax - level.astype(jnp.int32))).astype(jnp.uint32)
    return one << shift.astype(dt)


def remove_key(dtype) -> jax.Array:
    """Sentinel flagging particles for removal: 2^(3*maxLevel) (definitions.h:85-91)."""
    return node_range(dtype, 0)


# ----------------------------------------------------------------------------
# float -> integer grid conversion
# ----------------------------------------------------------------------------

def to_nbit_int(x: jax.Array, key_dtype) -> jax.Array:
    """Normalize x in [0,1] to integer grid coordinate, truncating (common.hpp:57-67)."""
    nbits = max_tree_level(key_dtype)
    result = (x * x.dtype.type(1 << nbits)).astype(jnp.int32)
    return jnp.minimum(result, jnp.int32((1 << nbits) - 1))


def to_nbit_int_ceil(x: jax.Array, key_dtype) -> jax.Array:
    """Like to_nbit_int but rounding up — used for halo radii (common.hpp:80-90)."""
    nbits = max_tree_level(key_dtype)
    result = jnp.ceil(x * x.dtype.type(1 << nbits)).astype(jnp.int32)
    return jnp.minimum(result, jnp.int32((1 << nbits) - 1))


# ----------------------------------------------------------------------------
# prefix / level math
# ----------------------------------------------------------------------------

def pad_prefix(prefix: jax.Array, length) -> jax.Array:
    """Zero-pad a key prefix of `length` bits out to the full key (common.hpp:109-113)."""
    dt = prefix.dtype
    lmax = max_tree_level(dt)
    if isinstance(length, (int, np.integer)):
        return prefix << (3 * lmax - int(length))
    return prefix << (3 * lmax - length).astype(dt)


def log8_ceil(n: jax.Array) -> jax.Array:
    """ceil(log8(n)); 0 for n == 0 (common.hpp:135-142)."""
    dt = n.dtype
    lmax = max_tree_level(dt)
    ub = unused_bits(dt)
    lz = count_leading_zeros(n - dt.type(1))
    return jnp.where(n == 0, jnp.int32(0), jnp.int32(lmax) - (lz - ub) // 3)


def is_power_of_8(n: jax.Array) -> jax.Array:
    """True where n is a power of 8 (common.hpp:145-150)."""
    dt = n.dtype
    lz = count_leading_zeros(n - dt.type(1)) - unused_bits(dt)
    return (lz % 3 == 0) & ((n & (n - dt.type(1))) == 0)


def common_prefix(k1: jax.Array, k2: jax.Array) -> jax.Array:
    """Number of common leading bits, excluding the unused bits (common.hpp:161-165)."""
    return count_leading_zeros(k1 ^ k2) - unused_bits(k1.dtype)


def tree_level(code_range: jax.Array) -> jax.Array:
    """Octree level whose node size equals `code_range` (common.hpp:173-178).

    code_range must be a power of 8 times node_range(maxLevel).
    """
    dt = code_range.dtype
    return (count_leading_zeros(code_range - dt.type(1)) - unused_bits(dt)) // 3


# ----------------------------------------------------------------------------
# Warren-Salmon placeholder-bit format
# ----------------------------------------------------------------------------

def encode_placeholder_bit(code: jax.Array, prefix_length) -> jax.Array:
    """Prepend a 1-bit above a key prefix (common.hpp:189-197)."""
    dt = code.dtype
    lmax = max_tree_level(dt)
    if isinstance(prefix_length, (int, np.integer)):
        n_shifts = 3 * lmax - int(prefix_length)
        mask = dt.type(1 << int(prefix_length))
        return (code >> n_shifts) | mask
    pl_ = prefix_length.astype(dt)
    n_shifts = (dt.type(3 * lmax) - pl_)
    return (code >> n_shifts) | (dt.type(1) << pl_)


def encode_placeholder_bit_2k(k1: jax.Array, k2: jax.Array) -> jax.Array:
    """Placeholder-bit key of the node spanning [k1, k2) (common.hpp:199-205)."""
    dt = k1.dtype
    prefix_length = count_leading_zeros(k2 - k1 - dt.type(1)) - unused_bits(dt)
    return encode_placeholder_bit(k1, prefix_length)


def decode_prefix_length(code: jax.Array) -> jax.Array:
    """Number of key bits in a placeholder-bit key (common.hpp:208-212)."""
    nbits = jnp.iinfo(code.dtype).bits
    return jnp.int32(nbits - 1) - count_leading_zeros(code)


def decode_placeholder_bit(code: jax.Array) -> jax.Array:
    """Inverse of encode_placeholder_bit (common.hpp:222-230)."""
    dt = code.dtype
    lmax = max_tree_level(dt)
    prefix_length = decode_prefix_length(code)
    mask = dt.type(1) << prefix_length.astype(dt)
    ret = code ^ mask
    return ret << (jnp.int32(3 * lmax) - prefix_length).astype(dt)


# ----------------------------------------------------------------------------
# key flagging (used to mark invalid/pruned treelet cells)
# ----------------------------------------------------------------------------

def mask_key(key: jax.Array) -> jax.Array:
    """Set the status bit above the key range (common.hpp:233-238)."""
    nr0 = remove_key(key.dtype)
    keep = (key == 0) | (key == nr0)
    return jnp.where(keep, key, key | nr0)


def unmask_key(key: jax.Array) -> jax.Array:
    """Inverse of mask_key (common.hpp:241-246)."""
    nr0 = remove_key(key.dtype)
    return jnp.where(key == nr0, key, key & (nr0 - key.dtype.type(1)))


def is_masked(key: jax.Array) -> jax.Array:
    return key > remove_key(key.dtype)


# ----------------------------------------------------------------------------
# octal digits / ancestors
# ----------------------------------------------------------------------------

def octal_digit(code: jax.Array, position) -> jax.Array:
    """The octal digit of `code` at tree level `position` (common.hpp:268-272)."""
    dt = code.dtype
    lmax = max_tree_level(dt)
    if isinstance(position, (int, np.integer)):
        return ((code >> (3 * (lmax - int(position)))) & dt.type(7)).astype(jnp.int32)
    shift = (3 * (lmax - position.astype(jnp.int32))).astype(dt)
    return ((code >> shift) & dt.type(7)).astype(jnp.int32)


def is_ancestor(a: jax.Array, b: jax.Array) -> jax.Array:
    """True if placeholder-key a is an ancestor of b, or a sibling of one (common.hpp:275-285)."""
    dt = a.dtype
    alen = decode_prefix_length(a)
    blen = decode_prefix_length(b)
    a_shifted = a << jnp.maximum(0, blen - alen).astype(dt)
    common_bits = count_leading_zeros(a_shifted ^ b)
    return common_bits >= 1 + count_leading_zeros(b) + jnp.maximum(0, alen - 3)


def digit_weight(digit: jax.Array) -> jax.Array:
    """Offset weight for binary tree <-> octree index mapping (common.hpp:288-292)."""
    four_geq = -(digit >= 4).astype(jnp.int32)
    return ((7 - digit) & four_geq) - (digit & ~four_geq)


def enclosing_box_code(key: jax.Array, level) -> jax.Array:
    """Start key of the level-`level` node containing `key` (common.hpp:295-301)."""
    mask = node_range(key.dtype, level) - key.dtype.type(1)
    return key & ~mask


def smallest_common_box(k1: jax.Array, k2: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """[start, end) keys of the smallest node containing both inputs (common.hpp:312-319)."""
    level = common_prefix(k1, k2) // 3
    node_start = enclosing_box_code(k1, level)
    return node_start, node_start + node_range(k1.dtype, level)


def zero_low_bits(code: jax.Array, n_bits) -> jax.Array:
    """Zero all but the highest n_bits of the usable key bits (common.hpp:322-329)."""
    dt = code.dtype
    lmax = max_tree_level(dt)
    if isinstance(n_bits, (int, np.integer)):
        mask = dt.type((1 << (3 * lmax - int(n_bits))) - 1)
    else:
        mask = (dt.type(1) << (jnp.int32(3 * lmax) - n_bits).astype(dt)) - dt.type(1)
    return code & ~mask


def last_nz_place(x: jax.Array) -> jax.Array:
    """Position (1-based from the left) of the last nonzero octal digit (common.hpp:339-346)."""
    lmax = max_tree_level(x.dtype)
    return jnp.where(
        x != 0,
        jnp.int32(lmax) - count_trailing_zeros(x) // 3,
        jnp.int32(lmax),
    )


def make_prefix(a: jax.Array) -> jax.Array:
    """Placeholder-bit prefix of the largest node starting at a (common.hpp:349-356)."""
    level = last_nz_place(a)
    pref = encode_placeholder_bit(a, 3 * level)
    return jnp.where(a == 0, a.dtype.type(1), pref)


def octal_power(dtype, pos) -> jax.Array:
    """8^(maxLevel - pos): key-range weight of octal place `pos` (common.hpp:364-368)."""
    dt = _canon(dtype)
    lmax = max_tree_level(dt)
    if isinstance(pos, (int, np.integer)):
        return jnp.asarray(1 << (3 * (lmax - int(pos))), dtype=dt)
    shift = (3 * (lmax - pos.astype(jnp.int32))).astype(dt)
    return dt.type(1) << shift


# ----------------------------------------------------------------------------
# SFC range cover ("spanSfcRange", common.hpp:392-438)
# ----------------------------------------------------------------------------
#
# The reference emits, for a key interval [a, b), the minimal sequence of
# cornerstone node start keys covering it. The JAX formulation computes, for
# each octal place, how many digits are emitted (a fixed 2*maxLevel-entry
# per-place count vector), so count and emission are both static-shaped.

def _span_place_counts(a: jax.Array, b: jax.Array):
    """Per-octal-place emission counts for the cover of [a, b).

    Returns (counts[2*lmax], place[2*lmax], sign[2*lmax]) where the first lmax
    entries walk up from a (ascending powers of 8) and the last lmax walk down
    toward b. Entries outside the active position window have count 0.
    """
    dt = a.dtype
    lmax = max_tree_level(dt)
    ub = unused_bits(dt)

    first_diff = (count_leading_zeros(a ^ b) + 3 - ub) // 3
    a_last = last_nz_place(a)
    b_last = last_nz_place(b)

    # pass 1: pos from a_last down to first_diff+1 : (8 - digit) % 8 emissions
    # per place. The reference mutates `a` as it emits (common.hpp:405-414);
    # arithmetically, once the first emission happens (at a_last, digit != 0),
    # every higher active place sees a carry of +1 on its original digit.
    pos_up = jnp.arange(lmax, 0, -1, dtype=jnp.int32)  # lmax .. 1
    dig_a = octal_digit(jnp.broadcast_to(a, (lmax,)), pos_up)
    carry = ((pos_up < a_last) & (a != 0)).astype(jnp.int32)
    cnt_up = (8 - (dig_a + carry)) % 8
    active_up = (pos_up <= a_last) & (pos_up > first_diff)
    cnt_up = jnp.where(active_up, cnt_up, 0)

    # after pass 1, a has been rounded up so that digits below first_diff are 0;
    # the rounded value is a + sum(cnt_up * 8^place)
    weights_up = octal_power(dt, pos_up)
    a_rounded = a + jnp.sum(jnp.where(active_up, cnt_up.astype(dt) * weights_up, dt.type(0)), dtype=dt)

    # pass 2: pos from first_diff up to b_last : digit(b,pos) - digit(a_rounded,pos)
    # place 0 is included: it is needed when b == nodeRange(0) (the root cover)
    pos_dn = jnp.arange(0, lmax + 1, dtype=jnp.int32)  # 0 .. lmax
    dig_b = octal_digit(jnp.broadcast_to(b, (lmax + 1,)), pos_dn)
    dig_ar = octal_digit(jnp.broadcast_to(a_rounded, (lmax + 1,)), pos_dn)
    cnt_dn = dig_b - dig_ar
    active_dn = (pos_dn >= first_diff) & (pos_dn <= b_last)
    cnt_dn = jnp.where(active_dn, cnt_dn, 0)

    return cnt_up, pos_up, cnt_dn, pos_dn, a_rounded


def span_sfc_range_count(a: jax.Array, b: jax.Array) -> jax.Array:
    """Number of cornerstone keys required to cover [a, b) (common.hpp:432-438)."""
    cnt_up, _, cnt_dn, _, _ = _span_place_counts(a, b)
    return (jnp.sum(cnt_up) + jnp.sum(cnt_dn)).astype(jnp.int32)


def span_sfc_range(a: jax.Array, b: jax.Array, capacity: int) -> Tuple[jax.Array, jax.Array]:
    """Cornerstone cover of [a, b): up to `capacity` keys plus a count.

    Output keys beyond the count are filled with b. Static-shaped equivalent
    of the reference's spanSfcRange store overload (common.hpp:392-430).
    """
    dt = a.dtype
    cnt_up, pos_up, cnt_dn, pos_dn, _ = _span_place_counts(a, b)

    counts = jnp.concatenate([cnt_up, cnt_dn])
    places = jnp.concatenate([pos_up, pos_dn])
    weights = octal_power(dt, places)

    total = jnp.sum(counts).astype(jnp.int32)
    offsets = jnp.cumsum(counts) - counts  # exclusive scan

    # emit slot j: find segment i with offsets[i] <= j < offsets[i]+counts[i]
    j = jnp.arange(capacity, dtype=jnp.int32)
    seg = jnp.searchsorted(offsets + counts, j, side="right").astype(jnp.int32)
    seg = jnp.minimum(seg, counts.shape[0] - 1)
    within = (j - offsets[seg]).astype(dt)

    # key at slot j = a + (prefix sums of full earlier segments) + within*weight[seg]
    seg_contrib = (counts.astype(dt) * weights)
    seg_prefix = jnp.cumsum(seg_contrib) - seg_contrib
    keys = a + seg_prefix[seg] + within * weights[seg]
    keys = jnp.where(j < total, keys, b)
    return keys, total
