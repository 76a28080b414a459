"""KV-cache ops for autoregressive decode (counterpart of
``paddle_tpu/ops/kernels_cache.py``).

The decode-step program keeps a slot-major key/value cache [slots, heads,
capacity, d_head] and updates one time column per step at a per-slot
position, so every shape is static: a decode loop of these steps can be
captured once in a CUDA graph and replayed for any sequence lengths.

The paged variants break each slot's row into fixed-size pages drawn from
one pool [num_pages, heads, page, d_head] through a per-slot page table
[slots, max_pages] of pool rows. Page 0 is the null page: masked writes
(finished slots) and positions past a table's reach land there, never
clamped onto a live page that another slot may share.

The registered ops are functional, as in the JAX package: each returns a
new cache and leaves its input as it is (``kv_cache_write`` and
``kv_cache_write_paged`` copy the whole cache). The generation engine
(inference/generation/engine.py) writes its resident cache in place with
``paged_write_`` and the same index arithmetic. Positions are int32 or
int64 and are never narrowed; indices are clamped before they index, so
none wraps.
"""

from __future__ import annotations

import torch

from ..registry import register_op
from .common import in_dtype, in_shape, set_out_var


# ---------------------------------------------------------------------------
# pure functions, shared by the registered ops and the decode engine
# ---------------------------------------------------------------------------

def paged_gather_fn(pool, table, cap=None):
    """The dense slot-major view of a paged cache: pool [P, H, page, D] +
    table [B, MP] -> [B, H, min(MP * page, cap), D]; row b is its table's
    pages in order (entry k covers positions [k * page, (k + 1) * page)).
    Unused entries point at the null page 0."""
    page = pool.shape[2]
    mp = table.shape[1]
    dense = pool[table.long()].permute(0, 2, 1, 3, 4).reshape(
        table.shape[0], pool.shape[1], mp * page, pool.shape[3])
    if cap is not None and cap < mp * page:
        dense = dense[:, :, :cap, :]
    return dense


def paged_write_index(table, pos, page, mask=None):
    """(pool row, offset) of each slot's write at ``pos`` [B]: page
    ``table[b, pos // page]`` at ``pos % page``, or the null page 0 where
    ``mask`` [B] (True = suppress) is set or ``pos`` lies past the table's
    reach (``max_pages * page``)."""
    mp = table.shape[1]
    pos = pos.reshape(-1).long()
    pidx_slot = torch.clamp(pos // page, 0, mp - 1)
    rows = torch.arange(table.shape[0], device=table.device)
    pidx = table.long()[rows, pidx_slot]
    off = torch.clamp(pos - pidx_slot * page, 0, page - 1)
    suppress = pos >= mp * page
    if mask is not None:
        suppress = suppress | mask.reshape(-1).bool()
    return torch.where(suppress, torch.zeros_like(pidx), pidx), off


def paged_write_(pool, table, pos, new, mask=None):
    """Write one K or V column into ``pool`` in place through ``table``:
    new [B, H, D] lands at ``paged_write_index``. Returns ``pool``."""
    pidx, off = paged_write_index(table, pos, pool.shape[2], mask)
    pool[pidx, :, off, :] = new.reshape(
        new.shape[0], pool.shape[1], pool.shape[3]).to(pool.dtype)
    return pool


def paged_write_fn(pool, table, pos, new, mask=None):
    """``paged_write_`` on a copy: the updated pool, ``pool`` unchanged."""
    return paged_write_(pool.clone(), table, pos, new, mask)


def dense_write_(cache, pos, new):
    """Write new [B, H, D] into cache [B, H, cap, D] in place at each
    slot's position, clamped into [0, cap - 1]. Returns ``cache``."""
    b, _h, cap, _d = cache.shape
    pos = torch.clamp(pos.reshape(-1).long(), 0, cap - 1)
    rows = torch.arange(b, device=cache.device)
    cache[rows, :, pos, :] = new.reshape(b, cache.shape[1],
                                         cache.shape[3]).to(cache.dtype)
    return cache


# ---------------------------------------------------------------------------
# the registered ops (inference only: no grad)
# ---------------------------------------------------------------------------

def _kv_cache_write_infer(op, block):
    cs = in_shape(block, op, "Cache")
    if cs is not None:
        for n in op.output("Out"):
            set_out_var(block, n, cs, in_dtype(block, op, "Cache"))


@register_op("kv_cache_write", no_grad=True, infer=_kv_cache_write_infer)
def kv_cache_write(ctx, ins, attrs):
    """Cache [B, H, cap, D] + New [B, H, 1, D] + Position [B] -> Out with
    Out[b, :, Position[b], :] = New[b, :, 0, :]; positions clamp to the
    capacity, so a finished slot keeps writing harmlessly."""
    new = ins["New"][0]
    return {"Out": [dense_write_(
        ins["Cache"][0].clone(), ins["Position"][0],
        new.reshape(new.shape[0], new.shape[1], new.shape[3]))]}


def _kv_cache_gather_paged_infer(op, block):
    ps = in_shape(block, op, "Pool")
    ts = in_shape(block, op, "Table")
    if ps is not None and ts is not None:
        cap = int(op.attrs.get("cap", 0) or 0)
        t = ts[-1] * ps[-2]
        if cap > 0:
            t = min(t, cap)
        # the per-slot view [H, T, D], as the dense cache feeds declare it
        for n in op.output("Out"):
            set_out_var(block, n, [ps[1], t, ps[3]],
                        in_dtype(block, op, "Pool"))


@register_op("kv_cache_gather_paged", no_grad=True,
             infer=_kv_cache_gather_paged_infer)
def kv_cache_gather_paged(ctx, ins, attrs):
    """Pool [P, H, page, D] + Table [B, MP] -> Out [B, H, min(MP * page,
    cap), D]; attr ``cap`` > 0 trims the tail of an overhanging page."""
    cap = int(attrs.get("cap", 0) or 0)
    return {"Out": [paged_gather_fn(ins["Pool"][0], ins["Table"][0],
                                    cap if cap > 0 else None)]}


def _kv_cache_write_paged_infer(op, block):
    ps = in_shape(block, op, "Pool")
    if ps is not None:
        for n in op.output("Out"):
            set_out_var(block, n, ps, in_dtype(block, op, "Pool"))


@register_op("kv_cache_write_paged", no_grad=True,
             infer=_kv_cache_write_paged_infer)
def kv_cache_write_paged(ctx, ins, attrs):
    """Pool [P, H, page, D] + Table [B, MP] + New [B, H, 1, D] + Position
    [B] (+ Mask [B] bool, True = suppress) -> the updated pool."""
    new = ins["New"][0]
    mask = ins["Mask"][0] if ins.get("Mask") else None
    return {"Out": [paged_write_fn(
        ins["Pool"][0], ins["Table"][0], ins["Position"][0],
        new.reshape(new.shape[0], new.shape[1], new.shape[3]), mask)]}
