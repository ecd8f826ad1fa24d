"""Multi-head attention layer with a swappable score mechanism.

Port of :mod:`repro.core.attention`.  The mechanism and the execution
backend both come from :mod:`repro_torch.core.mechanism`:
``plan_attention(cfg, shapes)`` returns an inspectable plan and
``apply_attention`` executes it.

Decode caches are updated **in place**: the new keys/values are written
into the layer's cache storage with ``index_put_`` (the reference's
functional ``.at[].set``), and the returned cache shares that storage
with only its cursor advanced.  A layer-stacked state must therefore own
real per-layer storage (``models.transformer.init_states`` allocates it
with ``torch.zeros``), never a broadcast view.

Tensor-parallel over ``model`` (parameters handed as a
:class:`~repro_torch.distributed.sharding.ModelShards`): ``wq`` / ``wk``
/ ``wv`` are column-parallel, ``wo`` row-parallel (its bias added once,
after the reduce), and every count comes from the local weights.  Where
``wk`` / ``wv`` are whole (the kv heads do not divide over ``model``),
K and V are projected whole, enter the region, and each rank keeps the
kv heads its query heads attend (:func:`split_kv_heads`); a cache then
holds those heads only.

Query rows over ``model`` (:func:`query_split`): an attention computed
whole (its heads do not fall into whole kv groups over ``model``) on a
sequence-parallel stream computes only the rank's s/M query rows, as the
reference's ``constrain(..., ("batch", "heads", "seq_sp"))`` shards its
score rows where the heads do not divide.  Its queries come from the
rank's own positions, its keys and values from the whole sequence, and
every weight's gradient, a share of the rank's rows, is summed over
``model`` (:func:`~repro_torch.distributed.sharding.at_positions`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core.mechanism import (
    DEFAULT_BLOCKED_THRESHOLD, DEFAULT_CHUNKED_THRESHOLD,
    MASK_FREE_BACKENDS, AttnShapes, PagedLayout, Structural, execute_plan,
    get_mechanism, plan_attention)
from repro_torch.distributed.sharding import (
    at_positions, enter_seq, into_model, is_split, model_rank, model_size,
    seq_parallel_on)
from repro_torch.nn.linear import apply_dense, dense_axes, init_dense


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    kind: Optional[str] = None      # DEPRECATED mechanism name; set
                                    # ``mechanism`` instead
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 64
    qkv_bias: bool = False
    out_bias: bool = False
    use_rope: bool = True
    rope_base: float = 10000.0
    rope_pct: float = 1.0           # fraction of head_dim rotated
    score_shift: float = 0.5        # inhibitor α (paper: 0.5)
    score_scale: Optional[float] = None  # default √head_dim (paper γ)
    normalize: bool = True          # key-count normalization
    sliding_window: Optional[int] = None
    causal: bool = True
    mechanism: Optional[str] = None  # registry name; None -> ``kind``
    backend: Optional[str] = None   # force a backend; None = planner auto
    use_kernel: bool = False        # DEPRECATED: shim for backend="pallas"
    kv_chunk: int = 256             # chunk size for streaming forms
    # kernel launch overrides (None = the kernel registry's choice)
    kernel_block_q: Optional[int] = None
    kernel_block_k: Optional[int] = None
    kernel_sub_k: Optional[int] = None
    kernel_pages_per_step: Optional[int] = None
    chunked_threshold: int = DEFAULT_CHUNKED_THRESHOLD
    blocked_threshold: int = DEFAULT_BLOCKED_THRESHOLD


class KVCache(NamedTuple):
    k: torch.Tensor       # (b, max_len, h_kv, d)
    v: torch.Tensor       # (b, max_len, h_kv, d)
    length: torch.Tensor  # () int32 shared cursor, or (b,) per-slot cursors


def init_kv_cache(batch: int, max_len: int, num_kv_heads: int,
                  head_dim: int, dtype=torch.bfloat16, *,
                  per_slot: bool = False, device=None) -> KVCache:
    shape = (batch, max_len, num_kv_heads, head_dim)
    length = torch.zeros((batch,) if per_slot else (), dtype=torch.int32,
                         device=device)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), length)


class PagedKVCache(NamedTuple):
    """Paged decode cache: KV rows live in a shared pool of fixed-size
    pages.  New tokens are written to ``block_tables[row, pos // ps]`` at
    offset ``pos % ps``.  Physical page 0 is the trash page: unmapped
    table entries point there, so inactive batch rows write harmlessly.
    ``block_tables`` and ``length`` are shared by every layer."""
    k: torch.Tensor             # (num_pages, page_size, h_kv, d) pool
    v: torch.Tensor             # (num_pages, page_size, h_kv, d) pool
    block_tables: torch.Tensor  # (b, pages_per_slot) int32
    length: torch.Tensor        # (b,) int32 per-slot cursors


def init_paged_kv_cache(batch: int, max_len: int, num_kv_heads: int,
                        head_dim: int, dtype=torch.bfloat16, *,
                        page_size: int = 16,
                        num_pages: Optional[int] = None,
                        device=None) -> PagedKVCache:
    pages_per_slot = -(-max_len // page_size)
    if num_pages is None:
        num_pages = batch * pages_per_slot + 1      # +1: trash page 0
    shape = (num_pages, page_size, num_kv_heads, head_dim)
    return PagedKVCache(
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros((batch, pages_per_slot), dtype=torch.int32,
                    device=device),
        torch.zeros((batch,), dtype=torch.int32, device=device))


def init_attention(gen: torch.Generator, cfg: AttentionConfig,
                   embed_dim: int, *, dtype=torch.float32,
                   device=None) -> dict:
    h, hk, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(dtype=dtype, device=device)
    return {
        "wq": init_dense(gen, (embed_dim,), (h, d), use_bias=cfg.qkv_bias,
                         **kw),
        "wk": init_dense(gen, (embed_dim,), (hk, d), use_bias=cfg.qkv_bias,
                         **kw),
        "wv": init_dense(gen, (embed_dim,), (hk, d), use_bias=cfg.qkv_bias,
                         **kw),
        "wo": init_dense(gen, (h, d), (embed_dim,), use_bias=cfg.out_bias,
                         **kw),
    }


def attention_axes(cfg: AttentionConfig) -> dict:
    """Logical axes of :func:`init_attention`'s tree."""
    return {
        "wq": dense_axes(("embed",), ("heads", "head_dim"),
                         use_bias=cfg.qkv_bias),
        "wk": dense_axes(("embed",), ("kv_heads", "head_dim"),
                         use_bias=cfg.qkv_bias),
        "wv": dense_axes(("embed",), ("kv_heads", "head_dim"),
                         use_bias=cfg.qkv_bias),
        "wo": dense_axes(("heads", "head_dim"), ("embed",),
                         use_bias=cfg.out_bias),
    }


def split_kv_heads(params, rank: Optional[int] = None) -> tuple:
    """(first, count): the kv heads that the query heads of ``model``
    rank ``rank`` (default this rank's) attend, for a split attention's
    gathered parameters.  The gather splits only where a rank's h/M
    query heads fall into whole groups of g = h/h_kv (h/M a multiple of
    g, or g of h/M), so they attend max(h/M / g, 1) kv heads from
    (rank · h/M) / g on."""
    m = model_size()
    h_local = params["wq"]["kernel"].shape[1]
    hk = params["wk"]["kernel"].shape[1] * (1 if "wk" in params.whole
                                            else m)
    group = h_local * m // hk
    rank = model_rank() if rank is None else rank
    return rank * h_local // group, max(h_local // group, 1)


def structural_mask_predicate(causal: bool, window, qi, kj):
    """Attendability of (query index ``qi``, key index ``kj``) under the
    causal / sliding-window structure: a window implies causality.
    Works on numpy arrays and tensors alike; None when unstructured."""
    masks = []
    if causal:
        masks.append(kj <= qi)
    if window is not None:
        masks.append((kj > qi - window) & (kj <= qi))
    if not masks:
        return None
    m = masks[0]
    for extra in masks[1:]:
        m = m & extra
    return m


def _build_mask(cfg: AttentionConfig, n_q: int, n_k: int, q_offset,
                kv_valid_len=None, *, device=None) -> Optional[torch.Tensor]:
    """Boolean (b|1, 1, n_q, n_k) mask combining causality, sliding window
    and KV-cache validity.  ``q_offset`` / ``kv_valid_len`` may be
    scalars or (b,) tensors."""
    masks = []
    qoff = torch.as_tensor(q_offset, device=device).reshape(-1)
    qi = qoff[:, None, None] + torch.arange(n_q, device=device)[None, :, None]
    kj = torch.arange(n_k, device=device)[None, None, :]
    structural = structural_mask_predicate(cfg.causal, cfg.sliding_window,
                                           qi, kj)
    if structural is not None:
        masks.append(structural)
    if kv_valid_len is not None:
        kv = torch.as_tensor(kv_valid_len, device=device).reshape(-1)
        masks.append((kj < kv[:, None, None]).expand(kv.shape[0], n_q, n_k))
    if not masks:
        return None
    m = masks[0]
    for extra in masks[1:]:
        m = m & extra
    return m[:, None]


def _write_paged(cache: PagedKVCache, k, v, n_q: int) -> None:
    """Scatter the new rows into the block-table pages, in place."""
    ps = cache.k.shape[1]
    b = k.shape[0]
    dev = cache.k.device
    pos = cache.length.long()[:, None] + torch.arange(n_q, device=dev)[None]
    logical = (pos // ps).clamp(max=cache.block_tables.shape[1] - 1)
    rows = torch.arange(b, device=dev)[:, None]
    pages = cache.block_tables.long()[rows, logical]             # (b, n_q)
    offs = pos % ps
    cache.k[pages, offs] = k.to(cache.k.dtype)
    cache.v[pages, offs] = v.to(cache.v.dtype)


def _write_contiguous(cache: KVCache, k, v, n_q: int) -> None:
    """Write the new rows at the cursor(s), in place; the start clamps to
    ``max_len - n_q`` as the reference's dynamic_update_slice does."""
    b, max_len = cache.k.shape[:2]
    dev = cache.k.device
    start = cache.length.long().reshape(-1).expand(b).clamp(
        0, max_len - n_q)
    pos = start[:, None] + torch.arange(n_q, device=dev)[None]
    rows = torch.arange(b, device=dev)[:, None]
    cache.k[rows, pos] = k.to(cache.k.dtype)
    cache.v[rows, pos] = v.to(cache.v.dtype)


def query_split(params) -> bool:
    """Does an attention of these gathered parameters compute only this
    ``model`` rank's query rows?  Where it is computed whole (not handed
    as a :class:`~repro_torch.distributed.sharding.ModelShards`) on a
    sequence-parallel stream: its input holds the rank's s/M positions."""
    return seq_parallel_on() and not is_split(params)


def apply_attention(params: dict, cfg: AttentionConfig, x: torch.Tensor, *,
                    x_kv: Optional[torch.Tensor] = None,
                    seq_kv: Optional[torch.Tensor] = None,
                    positions: Optional[torch.Tensor] = None,
                    cache=None, attn_mask: Optional[torch.Tensor] = None,
                    compute_dtype=None):
    """Attention of ``x`` (b, n_q, embed) over itself, or over ``x_kv``
    (b, n_kv, embed) when given (cross-attention).  Returns (y, cache').

    ``positions`` (b, n_q) are absolute RoPE positions (default: arange,
    or cache.length + arange when decoding).  Cross-attention applies no
    RoPE, plans with ``is_cross`` (so never a mask-free backend: it has
    no structural mask) and masks its keys only by the cache's valid
    length, when a cache is given.

    Under :func:`query_split` ``x`` holds this ``model`` rank's s/M
    positions of the sequence and ``y`` is its output there: the queries
    are those rows, the keys and values the whole sequence's, from
    ``seq_kv`` (b, s, embed), the norm output gathered by
    :func:`~repro_torch.distributed.sharding.enter_seq` (gathered here,
    with a reduce-scatter backward, when not given), or from ``x_kv``;
    ``positions`` then are the whole sequence's (b, s).
    """
    from repro_torch.nn.rotary import apply_rope

    cdt = compute_dtype or x.dtype
    b, n_q, _ = x.shape
    dev = x.device
    src = x if x_kv is None else x_kv
    q_start = 0

    rows = query_split(params)
    if rows:
        # each weight applied to the rank's share of the rows: its
        # gradient a partial, summed over ``model`` to stay whole
        params = {name: {k: at_positions(t) for k, t in leaf.items()}
                  for name, leaf in params.items()}
        if x_kv is None:
            src = seq_kv if seq_kv is not None else enter_seq(x, summed=True)
        # K / V's input gradient holds the rank's queries' share: summed
        # by the gather's reduce-scatter where it entered ``summed``,
        # else (a gather whose other readers compute whole, the
        # encoder's memory) all-reduced here
        src = into_model(src)
        q_start = model_rank() * n_q

    split = is_split(params)
    kv_whole = split and "wk" in params.whole
    xq = into_model(x) if split else x
    if split and not kv_whole:
        src = xq if x_kv is None else into_model(x_kv)
    q = apply_dense(params["wq"], xq, 1, cdt)         # (b, n_q, h, d)
    k = apply_dense(params["wk"], src, 1, cdt)        # (b, n_kv, hk, d)
    v = apply_dense(params["wv"], src, 1, cdt)
    if kv_whole:
        # projected whole on every model rank: the gradient of K and V
        # summed over the ranks, each keeping its query heads' kv heads
        first, count = split_kv_heads(params)
        k = into_model(k)[:, :, first:first + count]
        v = into_model(v)[:, :, first:first + count]

    if positions is None:
        n_pos = k.shape[1] if rows else n_q
        ar = torch.arange(n_pos, device=dev)[None, :]
        if cache is None:
            positions = ar
        else:
            off = cache.length.long()
            positions = off[:, None] + ar if off.dim() == 1 else ar + off
        positions = positions.expand(b, n_pos)
    # a query split's queries sit at rank · s/M + i, its keys at 0 … s−1:
    # rotated from 0, a slice would agree with the reference on rank 0 only
    q_positions = positions[:, q_start:q_start + n_q] if rows else positions

    if cfg.use_rope and x_kv is None:
        if cfg.rope_pct >= 1.0:
            q = apply_rope(q, q_positions, base=cfg.rope_base)
            k = apply_rope(k, positions, base=cfg.rope_base)
        else:
            rd = int(cfg.head_dim * cfg.rope_pct)
            rd -= rd % 2
            q = torch.cat([apply_rope(q[..., :rd], q_positions,
                                      base=cfg.rope_base), q[..., rd:]], -1)
            k = torch.cat([apply_rope(k[..., :rd], positions,
                                      base=cfg.rope_base), k[..., rd:]], -1)

    new_cache = None
    kv_valid_len = None
    paged_layout = None
    if isinstance(cache, PagedKVCache):
        _write_paged(cache, k, v, n_q)
        new_cache = cache._replace(length=cache.length + n_q)
        k, v = cache.k.to(cdt), cache.v.to(cdt)
        kv_valid_len = new_cache.length
        n_k = cache.block_tables.shape[1] * cache.k.shape[1]
        paged_layout = PagedLayout(cache.block_tables, cache.k.shape[1])
    elif cache is not None:
        _write_contiguous(cache, k, v, n_q)
        new_cache = cache._replace(length=cache.length + n_q)
        k, v = cache.k.to(cdt), cache.v.to(cdt)
        kv_valid_len = new_cache.length

    if paged_layout is None:
        n_k = k.shape[1]
    # the offset moves the causal / window structure, and with it the
    # inhibitor's count of attended keys a row (``normalize``) and the
    # rows its backward visits a key chunk; a query split's keys past its
    # last query are causally masked but valid (no kv_valid_len)
    q_offset = cache.length if cache is not None else q_start
    scalar_cursor = cache is None or cache.length.dim() == 0

    shapes = AttnShapes(
        batch=b, n_q=n_q, n_k=n_k, num_heads=q.shape[2],
        num_kv_heads=k.shape[2], head_dim=cfg.head_dim, dtype=q.dtype,
        has_explicit_mask=attn_mask is not None, is_cross=x_kv is not None,
        has_cache=cache is not None, scalar_cursor=scalar_cursor,
        platform=dev.type, paged=paged_layout is not None)
    plan = plan_attention(cfg, shapes)
    mech = get_mechanism(plan.mechanism)
    mech_params = mech.make_params(
        score_scale=cfg.score_scale, score_shift=cfg.score_shift,
        normalize=cfg.normalize, kv_chunk=cfg.kv_chunk,
        kernel_block_q=cfg.kernel_block_q, kernel_block_k=cfg.kernel_block_k,
        kernel_sub_k=cfg.kernel_sub_k,
        kernel_pages_per_step=cfg.kernel_pages_per_step)

    if plan.backend in MASK_FREE_BACKENDS:
        structural = Structural(causal=cfg.causal, window=cfg.sliding_window,
                                q_offset=q_offset, kv_valid_len=kv_valid_len)
        out = execute_plan(plan, q, k, v, params=mech_params,
                           structural=structural, paged=paged_layout)
    else:
        mask = attn_mask
        if mask is None and x_kv is None:
            mask = _build_mask(cfg, n_q, n_k, q_offset, kv_valid_len,
                               device=dev)
        elif mask is None and kv_valid_len is not None:
            # cross-attention over a cache: only its valid keys
            kvl = kv_valid_len.reshape(-1)
            mask = (torch.arange(n_k, device=dev)[None, :]
                    < kvl[:, None])[:, None, None]
        out = execute_plan(plan, q, k, v, mask=mask, params=mech_params,
                           paged=paged_layout)

    y = apply_dense(params["wo"], out, 2, cdt,        # out: (b, n_q, h, d)
                    reduce=split)
    return y, new_cache
