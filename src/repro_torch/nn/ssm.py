"""RWKV-6 (Finch) time-mix and channel-mix, the attention-free token mixer
of the ``ssm`` family, and the selective SSM (Mamba) block of the
``hybrid`` family's parallel SSM heads.

Port of :mod:`repro.nn.ssm`.  The paper's inhibitor replaces dot-product
attention; these layers have none, so they run without it.  The Mamba
scan (:func:`selective_scan_ref`) is a Python loop over time in float32,
as the reference's ``lax.scan``; the reference has no kernel for it.

The WKV recurrence per head (state S ∈ R^{n×n}, n = head_dim)::

    S_t = diag(w_t) · S_{t-1} + k_tᵀ v_t
    o_t = r_t · (S_{t-1} + diag(u) · k_tᵀ v_t)

has three forms here:

  * :func:`wkv6_scan_ref` — the exact recurrence, a Python loop over t
    (the reference's ``lax.scan``): decode, and the CPU's training path;
  * :func:`wkv6_chunk` / :func:`wkv6_chunk_state` — one chunk of the
    chunked form that the CUDA kernel computes (``kernels.rwkv6``), in
    differentiable torch: the carry term through the incoming state, the
    strictly lower intra-chunk matrix with every exponent ≤ 0, the
    diagonal bonus and the state update;
  * :func:`wkv6_chunked_vjp` — the kernel's backward: the chunk-start
    states recomputed forward, then autograd through :func:`wkv6_chunk`
    one chunk at a time from the last, so no more than one chunk's
    (L, L, n) cubes are alive at once.

Tensor-parallel over ``model`` (parameters handed as a
:class:`~repro_torch.distributed.sharding.ModelShards`; every count comes
from the local weights):

  * the time-mix computes the rank's h/M heads: ``receptance``, ``key``,
    ``value`` and ``gate`` column-parallel, ``output`` row-parallel; the
    ddlerp token-shift mix and the decay LoRA's hidden layer are
    whole-width work, computed alike on every rank outside the region;
    the per-head leaves on ``embed`` (``u``, ``w_base``, ``ln_x``, the
    columns of ``w_lora_b``) are sliced to the rank's heads;
  * the channel-mix splits its squared-ReLU FFN (``key`` column-, ``value``
    row-parallel); its ``receptance`` gate is gathered whole and computed
    outside the region;
  * the Mamba block computes the rank's c/M inner channels: its two blocks
    of ``in_proj``'s columns, the conv, ``dt_proj`` and the scan on them,
    ``x_proj`` and ``out_proj`` row-parallel.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (into_model, into_region,
                                              is_split, model_rank,
                                              out_of_model, own_positions)
from repro_torch.nn.init import normal
from repro_torch.nn.linear import apply_dense, dense_axes, init_dense
from repro_torch.nn.norm import (apply_groupnorm, init_groupnorm,
                                 layernorm_axes)

#: floor of the decay before its log: a *normal* float32 value, so a
#: decay that underflows to 0 (or to a flushed subnormal) still gives a
#: finite log
W_FLOOR = 1e-30


# ---------------------------------------------------------------------------
# time-mix
# ---------------------------------------------------------------------------

def init_rwkv6_timemix(gen: torch.Generator, embed_dim: int, num_heads: int,
                       *, lora_dim: int = 64, decay_lora_dim: int = 64,
                       dtype=torch.float32, device=None) -> dict:
    """RWKV-6 time-mix: token-shift LoRA mixers + r/k/v/g/w projections."""
    if embed_dim % num_heads:
        raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                         f"num_heads {num_heads}")
    kw = dict(dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, **kw)

    def lin():
        return init_dense(gen, (embed_dim,), (embed_dim,), **kw)

    return {
        # token-shift base mix coefficients (mu) for x_t vs x_{t-1}
        "mu_base": zeros(5, embed_dim),
        # data-dependent mix: x -> lora_dim -> 5*embed (stacked LoRA,
        # "ddlerp")
        "mix_lora_a": normal(gen, (embed_dim, 5 * lora_dim), 0.01, **kw),
        "mix_lora_b": zeros(5, lora_dim, embed_dim),
        "receptance": lin(),
        "key": lin(),
        "value": lin(),
        "gate": lin(),
        # decay: base + LoRA(x) -> per-channel decay logits
        "w_base": torch.full((embed_dim,), -6.0, **kw),
        "w_lora_a": normal(gen, (embed_dim, decay_lora_dim), 0.01, **kw),
        "w_lora_b": zeros(decay_lora_dim, embed_dim),
        # per-channel "bonus" for the current token
        "u": zeros(embed_dim),
        "output": lin(),
        "ln_x": init_groupnorm(num_heads, embed_dim, **kw),
    }


def rwkv6_timemix_axes() -> dict:
    """Logical axes of :func:`init_rwkv6_timemix`'s tree."""
    lin = dense_axes(("embed",), ("heads_mlp",))
    return {
        "mu_base": (None, "embed"),
        "mix_lora_a": ("embed", None),
        "mix_lora_b": (None, None, "embed"),
        "receptance": lin, "key": dict(lin), "value": dict(lin),
        "gate": dict(lin),
        "w_base": ("embed",),
        "w_lora_a": ("embed", None),
        "w_lora_b": (None, "embed"),
        "u": ("embed",),
        "output": dense_axes(("heads_mlp",), ("embed",)),
        "ln_x": layernorm_axes(),
    }


def _token_shift(x: torch.Tensor,
                 prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Shift the sequence right by one; ``prev`` (b, d) is the carry token
    of decode."""
    prev = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None]
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


def _rank_columns(params, leaf: torch.Tensor, width: int) -> torch.Tensor:
    """This ``model`` rank's ``width`` columns (last dim) of a leaf that a
    split layer holds whole, else the leaf.  The trap of RWKV-6's
    per-head leaves on ``embed`` (``u``, ``w_base``, ``ln_x``, the columns
    of ``w_lora_b``): the leaf is whole on every rank (``Replicate`` over
    ``model``) but acts per head, and a slice would get a gradient in its
    columns only; through :func:`into_model` first, the ranks' slices'
    gradients are summed into the whole leaf's, equal on every rank."""
    if not is_split(params):
        return leaf
    lo = model_rank() * width
    return into_model(leaf)[..., lo:lo + width]


def rwkv6_projections(params: dict, x: torch.Tensor, num_heads: int,
                      x_prev: Optional[torch.Tensor] = None,
                      compute_dtype=None):
    """r, k, v, g and the decay w with RWKV-6's ddlerp token shift.

    x: (batch, seq, d).  Returns r, k, v (batch, seq, heads, head_dim) in
    the compute dtype, the gate g (batch, seq, d) and the decay
    w = exp(-exp(w_logit)) (batch, seq, heads, head_dim) in float32; for
    a split time-mix the rank's heads (and g its d/M columns).
    """
    cdt = compute_dtype or x.dtype
    b, s, d = x.shape
    hd = d // num_heads
    split = is_split(params)
    width = params["receptance"]["kernel"].shape[-1]      # d, or d/M
    heads = width // hd
    xf = x.float()
    dx = (_token_shift(x, x_prev) - x).float()

    mu = params["mu_base"].float()                    # (5, d)
    la = params["mix_lora_a"].float()                 # (d, 5 r)
    lb = params["mix_lora_b"].float()                 # (5, r, d)
    r_dim = lb.shape[1]
    base = xf + dx * mu[:, None, None, :]             # (5, b, s, d)
    z = torch.tanh((xf @ la).reshape(b, s, 5, r_dim)).permute(2, 0, 1, 3)
    dd = torch.einsum("nbsr,nrd->nbsd", z, lb)
    mixed = base + dx * dd                            # (5, b, s, d)
    xw, xk, xv, xr, xg = (m.to(cdt) for m in mixed)
    # the decay LoRA's hidden layer, whole width
    hid = torch.tanh(xw.float() @ params["w_lora_a"].float())
    if split:
        # whole-width work that feeds split projections: the ddlerp mix
        # and the decay LoRA's hidden layer are computed alike on every
        # rank; each enters the region, so their gradients (and those of
        # mu_base and the LoRAs) are summed over the ranks, whole and equal
        xk, xv, xr, xg, hid = (into_model(t) for t in (xk, xv, xr, xg, hid))

    r = apply_dense(params["receptance"], xr, 1, cdt).reshape(
        b, s, heads, hd)
    k = apply_dense(params["key"], xk, 1, cdt).reshape(b, s, heads, hd)
    v = apply_dense(params["value"], xv, 1, cdt).reshape(b, s, heads, hd)
    g = F.silu(apply_dense(params["gate"], xg, 1, cdt))

    w_logit = (_rank_columns(params, params["w_base"], width).float()
               + hid @ _rank_columns(params, params["w_lora_b"],
                                     width).float())
    w = torch.exp(-torch.exp(w_logit)).reshape(b, s, heads, hd)
    return r, k, v, g, w


def wkv6_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor,
                  state: Optional[torch.Tensor] = None):
    """The exact RWKV-6 recurrence, one step per position (the oracle).

    r, k, v, w: (b, t, h, n); u: (h, n); state: (b, h, n, n) or None
    (zero).  Returns (out (b, t, h, n) float32, final state (b, h, n, n)
    float32)."""
    b, t, h, n = r.shape
    S = (torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
         if state is None else state.float())
    r, k, v, w = (x.float() for x in (r, k, v, w))
    bonus = u.float()[None, :, :, None]
    outs = []
    for i in range(t):
        kv = k[:, i, :, :, None] * v[:, i, :, None, :]       # (b, h, n, n)
        outs.append(torch.einsum("bhn,bhnm->bhm", r[:, i], S + bonus * kv))
        S = w[:, i, :, :, None] * S + kv
    if not outs:
        return r.new_zeros((b, 0, h, n)), S
    return torch.stack(outs, dim=1), S


def wkv6_log_decay(w: torch.Tensor) -> torch.Tensor:
    """log w with the decay floored at :data:`W_FLOOR` first."""
    return torch.log(torch.clamp_min(w.float(), W_FLOOR))


def _segment_masks(L: int, device):
    """0/1 float masks that sum the log-decay over segments of a chunk:
    ``before[t, j] = [j < t]``, ``after[s, j] = [j > s]`` and
    ``between[t, s, j] = [s < j < t]``."""
    i = torch.arange(L, device=device)
    before = (i[None, :] < i[:, None]).float()
    between = ((i[None, :, None] < i[None, None, :])
               & (i[None, None, :] < i[:, None, None])).float()
    return before, before.t(), between


def wkv6_chunk(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logw: torch.Tensor, u: torch.Tensor, S: torch.Tensor):
    """One chunk of the chunked form, differentiable.

    r, k, v, logw: (b, h, L, n) float32 (logw ≤ 0); u: (h, n); S: (b, h,
    n, n), the state before the chunk.  Returns (o (b, h, L, n), the state
    after the chunk).  Every exponent is a sum of log-decays over the
    positions it spans, so ≤ 0: no exp overflows at any decay.  The
    kernel forms the same exponents as differences of the chunk's
    cumulative sum; here each is summed over its own segment, so its
    gradient in log w is a sum of the terms that hold that decay, with no
    cancellation (a difference of cumulative sums would leave rounding of
    the size of the whole sum, which the chain rule through log w then
    divides by w)."""
    L = r.shape[-2]
    before, _, between = _segment_masks(L, r.device)
    # carry term: (r_t ⊙ e^{Σ_{j<t} log w_j}) @ S
    o = (r * torch.exp(before @ logw)) @ S
    # intra-chunk: A[t,s] = Σ_n r_tn k_sn e^{Σ_{s<j<t} log w_jn}, s < t
    expo = torch.einsum("tsj,bhjn->bhtsn", between, logw)
    tri = torch.ones((L, L), dtype=torch.bool, device=r.device).tril(-1)
    w_ts = torch.exp(expo) * tri[..., None]
    A = torch.einsum("bhtn,bhsn,bhtsn->bhts", r, k, w_ts)
    # diagonal bonus: (r_t ⊙ u ⊙ k_t) · v_t
    diag = (r * u[:, None, :] * k).sum(-1, keepdim=True)       # (b, h, L, 1)
    o = o + A @ v + diag * v
    return o, wkv6_chunk_state(k, v, logw, S)


def wkv6_chunk_state(k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
                     S: torch.Tensor):
    """The state after one chunk: S ← diag(e^{Σ_j log w_j}) S + Σ_s (k_s ⊙
    e^{Σ_{j>s} log w_j})ᵀ v_s (shapes as :func:`wkv6_chunk`)."""
    _, after, _ = _segment_masks(logw.shape[-2], logw.device)
    k_scaled = k * torch.exp(after @ logw)
    total = logw.sum(-2, keepdim=True)                 # (b, h, 1, n)
    return (torch.exp(total).transpose(-1, -2) * S
            + k_scaled.transpose(-1, -2) @ v)


def to_chunks(x: torch.Tensor, chunk: int, fill: float = 0.0):
    """(b, t, h, n) -> (b, h, t_padded, n) float32, the tail up to a
    multiple of ``chunk`` filled with ``fill``."""
    x = x.float().transpose(1, 2)
    pad = -x.shape[2] % chunk
    return F.pad(x, (0, 0, 0, pad), value=fill) if pad else x


def wkv6_chunked_form(r, k, v, w, u, *, chunk: int):
    """The chunked form from a zero state, chunk after chunk: what the
    kernel computes.  The padded tail has zero k, v and a decay of 1 (log
    0), so it adds nothing to the state.  Returns (out (b, t, h, n), final
    state (b, h, n, n)), float32."""
    b, t, h, n = r.shape
    R, K, V = (to_chunks(x, chunk) for x in (r, k, v))
    LW = wkv6_log_decay(to_chunks(w, chunk, fill=1.0))
    uf = u.float()
    S = torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
    outs = []
    for c0 in range(0, R.shape[2], chunk):
        sl = slice(c0, c0 + chunk)
        o, S = wkv6_chunk(R[:, :, sl], K[:, :, sl], V[:, :, sl],
                          LW[:, :, sl], uf, S)
        outs.append(o)
    out = (torch.cat(outs, dim=2) if outs
           else R.new_zeros((b, h, 0, n)))
    return out[:, :, :t].transpose(1, 2), S


def wkv6_chunked_vjp(r, k, v, w, u, g_out, g_state, *, chunk: int):
    """Gradients of (out, final state) of the chunked form from a zero
    state with respect to r, k, v, w and u, given their cotangents
    ``g_out`` (b, t, h, n) and ``g_state`` (b, h, n, n) (either may be
    None: zero).  Recomputes the chunk-start states, then walks the
    chunks from the last, each through autograd on :func:`wkv6_chunk`
    alone.  Below the floor the decay's gradient is 0 (the floored log is
    constant there).  Gradients come back in the inputs' dtypes."""
    b, t, h, n = r.shape
    R, K, V = (to_chunks(x, chunk) for x in (r, k, v))
    W = to_chunks(w, chunk, fill=1.0)
    G = (torch.zeros_like(R) if g_out is None
         else to_chunks(g_out, chunk))
    uf = u.detach().float()
    starts = list(range(0, R.shape[2], chunk))
    S = torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
    states = []
    with torch.no_grad():
        for c0 in starts:
            states.append(S)
            sl = slice(c0, c0 + chunk)
            S = wkv6_chunk_state(K[:, :, sl], V[:, :, sl],
                                 wkv6_log_decay(W[:, :, sl]), S)
    gS = (torch.zeros_like(S) if g_state is None else g_state.float())
    grads = [torch.zeros_like(R) for _ in range(4)]
    gu = torch.zeros_like(uf)
    for c0, S0 in zip(reversed(starts), reversed(states)):
        sl = slice(c0, c0 + chunk)
        leaves = [X[:, :, sl].detach().requires_grad_()
                  for X in (R, K, V, W)]
        lu = uf.clone().requires_grad_()
        lS = S0.requires_grad_()
        with torch.enable_grad():
            o, S1 = wkv6_chunk(*leaves[:3], wkv6_log_decay(leaves[3]), lu,
                               lS)
            *g_rkvw, g_u, gS = torch.autograd.grad(
                (o, S1), leaves + [lu, lS], (G[:, :, sl], gS))
        for acc, g in zip(grads, g_rkvw):
            acc[:, :, sl] = g
        gu += g_u
    return (tuple(g[:, :, :t].transpose(1, 2).to(x.dtype)
                  for g, x in zip(grads, (r, k, v, w)))
            + (gu.to(u.dtype),))


def apply_rwkv6_timemix(params: dict, x: torch.Tensor, num_heads: int, *,
                        state: Optional[torch.Tensor] = None,
                        x_prev: Optional[torch.Tensor] = None,
                        use_kernel: bool = False, compute_dtype=None):
    """The full RWKV-6 time-mix.  Returns (y, (final wkv state, last
    token)).  ``use_kernel`` runs the WKV through ``kernels.ops.wkv6`` (the
    CUDA kernel from a zero state), else the exact scan.  A split
    time-mix runs the WKV on its h/M heads (``state`` and the final state
    those heads' (b, h/M, n, n)), the same kernel at fewer heads, and its
    row-parallel output is summed over the ranks."""
    b, s, d = x.shape
    hd = d // num_heads
    cdt = compute_dtype or x.dtype
    r, k, v, g, w = rwkv6_projections(params, x, num_heads, x_prev, cdt)
    heads, width = r.shape[2], r.shape[2] * hd
    u = _rank_columns(params, params["u"], width).float().reshape(heads, hd)
    if use_kernel:
        from repro_torch.kernels import ops as kops
        out, final = kops.wkv6(r, k, v, w, u, state)
    else:
        out, final = wkv6_scan_ref(r, k, v, w, u, state)
    # ln_x is a group norm with one group per head: the rank's h/M groups
    ln_x = {n: _rank_columns(params, t, width)
            for n, t in params["ln_x"].items()}
    out = apply_groupnorm(ln_x, out.reshape(b, s, width).to(cdt), heads)
    y = apply_dense(params["output"], out * g.to(cdt), 1, cdt,
                    reduce=is_split(params))
    return y, (final, x[:, -1])


# ---------------------------------------------------------------------------
# channel-mix
# ---------------------------------------------------------------------------

def init_rwkv6_channelmix(gen: torch.Generator, embed_dim: int,
                          hidden_dim: int, *, dtype=torch.float32,
                          device=None) -> dict:
    kw = dict(dtype=dtype, device=device)
    return {
        "mu_k": torch.zeros(embed_dim, **kw),
        "mu_r": torch.zeros(embed_dim, **kw),
        "key": init_dense(gen, (embed_dim,), (hidden_dim,), **kw),
        "receptance": init_dense(gen, (embed_dim,), (embed_dim,), **kw),
        "value": init_dense(gen, (hidden_dim,), (embed_dim,), **kw),
    }


def rwkv6_channelmix_axes() -> dict:
    return {
        "mu_k": ("embed",),
        "mu_r": ("embed",),
        "key": dense_axes(("embed",), ("mlp",)),
        "receptance": dense_axes(("embed",), ("heads_mlp",)),
        "value": dense_axes(("mlp",), ("embed",)),
    }


def apply_rwkv6_channelmix(params: dict, x: torch.Tensor, *,
                           x_prev: Optional[torch.Tensor] = None,
                           compute_dtype=None):
    """RWKV channel-mix: squared-ReLU FFN with token shift and a
    receptance gate.  Returns (y, last token).  Split, the FFN is the
    rank's slice of the hidden width (``key`` column-, ``value``
    row-parallel, summed over the ranks); the receptance gate multiplies
    the *summed* output elementwise, so its ``receptance`` is gathered
    whole and computed outside the region, alike on every rank (over the
    whole sequence, then taken at the summed output's positions)."""
    cdt = compute_dtype or x.dtype
    dx = _token_shift(x, x_prev) - x
    xk = x + dx * params["mu_k"].to(cdt)
    xr = x + dx * params["mu_r"].to(cdt)
    kk = torch.square(F.relu(apply_dense(params["key"],
                                         into_region(params, xk), 1, cdt)))
    vv = apply_dense(params["value"], kk, 1, cdt, reduce=is_split(params))
    rr = torch.sigmoid(apply_dense(params["receptance"], xr, 1, cdt))
    # the whole gate at the positions the summed output left at (a
    # sequence-parallel stream's: the rank's own)
    return own_positions(rr, vv.shape[1]) * vv, x[:, -1]


# ---------------------------------------------------------------------------
# selective SSM (Mamba) for the hybrid family's parallel SSM heads
# ---------------------------------------------------------------------------

def init_mamba(gen: torch.Generator, embed_dim: int, inner_dim: int, *,
               state_dim: int = 16, conv_dim: int = 4,
               dt_rank: Optional[int] = None, dtype=torch.float32,
               device=None) -> dict:
    """Mamba block: in/out projections, the depthwise causal conv, the
    x -> (dt, B, C) projection, and the S4D-real ``A_log`` = log [1..n]
    per channel (float32, as ``D``)."""
    kw = dict(dtype=dtype, device=device)
    dt_rank = dt_rank or max(1, embed_dim // 16)
    a_init = torch.arange(1, state_dim + 1, dtype=torch.float32,
                          device=device)[None, :].repeat(inner_dim, 1)
    return {
        "in_proj": init_dense(gen, (embed_dim,), (2 * inner_dim,), **kw),
        "conv_w": normal(gen, (conv_dim, inner_dim), conv_dim ** -0.5, **kw),
        "conv_b": torch.zeros(inner_dim, **kw),
        "x_proj": init_dense(gen, (inner_dim,), (dt_rank + 2 * state_dim,),
                             **kw),
        "dt_proj": init_dense(gen, (dt_rank,), (inner_dim,), use_bias=True,
                              **kw),
        "A_log": torch.log(a_init),
        "D": torch.ones(inner_dim, dtype=torch.float32, device=device),
        "out_proj": init_dense(gen, (inner_dim,), (embed_dim,), **kw),
    }


def mamba_axes() -> dict:
    """Logical axes of :func:`init_mamba`'s tree."""
    return {
        "in_proj": dense_axes(("embed",), ("mlp",)),
        "conv_w": (None, "mlp"),
        "conv_b": ("mlp",),
        "x_proj": dense_axes(("mlp",), (None,)),
        "dt_proj": dense_axes((None,), ("mlp",), use_bias=True),
        "A_log": ("mlp", None),
        "D": ("mlp",),
        "out_proj": dense_axes(("mlp",), ("embed",)),
    }


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          carry: Optional[torch.Tensor] = None):
    """x: (b, t, c); w: (k, c) depthwise causal conv over time, continuing
    from ``carry`` (the last k − 1 inputs, (b, k − 1, c); zeros when
    None).  Returns (y, new carry)."""
    k = w.shape[0]
    if carry is None:
        carry = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([carry.to(x.dtype), x], dim=1)
    t = x.shape[1]
    # the sum of shifted slices, in the reference's order (k is 4)
    y = xp[:, 0:t] * w[0][None, None, :]
    for i in range(1, k):
        y = y + xp[:, i:i + t] * w[i][None, None, :]
    new_carry = xp[:, -(k - 1):] if k > 1 else None
    return y + b[None, None, :], new_carry


def selective_scan_ref(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                       state: Optional[torch.Tensor] = None):
    """The Mamba selective scan, a Python loop over time in float32 (the
    reference's ``lax.scan``).

    u, dt: (b, t, c); A (the ``A_log`` parameter): (c, n); B, C: (b, t,
    n); D: (c,).  State (b, c, n)::

        S_t = exp(dt_t · −exp(A)) · S_{t−1} + dt_t · B_t · u_t
        y_t = S_t · C_t + D · u_t

    Returns (y (b, t, c), final state)."""
    b, t, c = u.shape
    n = A.shape[1]
    if state is None:
        state = u.new_zeros((b, c, n), dtype=torch.float32)
    dA = torch.exp(dt[..., None] * (-torch.exp(A))[None, None])  # (b,t,c,n)
    dBu = dt[..., None] * B[:, :, None, :] * u[..., None]         # (b,t,c,n)
    Cf = C.float()
    S = state.float()
    ys = []
    for i in range(t):
        S = dA[:, i] * S + dBu[:, i]
        ys.append(torch.einsum("bcn,bn->bc", S, Cf[:, i]))
    y = torch.stack(ys, dim=1) + u * D[None, None, :]
    return y, S


def apply_mamba(params: dict, x: torch.Tensor, *, state_dim: int = 16,
                ssm_state: Optional[torch.Tensor] = None,
                conv_state: Optional[torch.Tensor] = None,
                compute_dtype=None):
    """Mamba block forward from the carries (zeros when None).  Returns
    (y, (ssm state (b, c, n) float32, conv carry (b, k − 1, c))); a split
    block's carries are its c/M channels, and its output is summed over
    the ranks."""
    cdt = compute_dtype or x.dtype
    split = is_split(params)
    if split:
        # in_proj's out dim is [x | z]: a rank's share is its channels'
        # block of each half, [r·c/M, (r+1)·c/M) and c + the same, sliced
        # from the leaf gathered whole; through into_model, so the
        # leaf's gradient (the rank's blocks) is summed over the ranks
        c = params["conv_b"].shape[0]
        kernel = into_model(params["in_proj"]["kernel"])
        half, lo = kernel.shape[-1] // 2, model_rank() * c
        xz = apply_dense({"kernel": torch.cat(
            [kernel[:, lo:lo + c], kernel[:, half + lo:half + lo + c]], -1)},
            into_model(x), 1, cdt)
    else:
        xz = apply_dense(params["in_proj"], x, 1, cdt)
    xs, z = xz.chunk(2, dim=-1)
    xs, new_conv = _causal_depthwise_conv(
        xs, params["conv_w"].to(cdt), params["conv_b"].to(cdt), conv_state)
    xs = F.silu(xs)
    proj = apply_dense(params["x_proj"], xs, 1, cdt)
    if split:
        # the reduce in the middle of the region: x_proj is row-parallel,
        # and dt_low, B and C feed split compute (dt_proj's columns, the
        # rank's channels of the scan), so they are summed over the ranks
        # forward (whole on every rank, at every position: never a
        # sequence's reduce-scatter), and their partial gradients summed
        # backward
        proj = into_model(out_of_model(proj))
    dt_rank = proj.shape[-1] - 2 * state_dim
    dt_low, B, C = proj.split([dt_rank, state_dim, state_dim], dim=-1)
    dt = F.softplus(apply_dense(params["dt_proj"], dt_low, 1, cdt).float())
    y, new_ssm = selective_scan_ref(
        xs.float(), dt, params["A_log"].float(), B.float(), C.float(),
        params["D"].float(), ssm_state)
    y = y.to(cdt) * F.silu(z)
    return (apply_dense(params["out_proj"], y, 1, cdt, reduce=split),
            (new_ssm, new_conv))
