"""Plain PyTorch versions of every hand-written kernel.

Each mirrors one kernel's contract (shapes, dtypes, masking) with
straight-line tensor code in the direct-sum form of
``repro/kernels/ref.py`` (``wkv6_ref``: a plain loop over T), or of the
reference's model code where the kernel has no Pallas twin
(``dtw_band_ref``, ``rg_lru_scan_ref``). They are what
a CPU tensor runs, and what the card checks each kernel against. Work over the series axis is cut into row
blocks so the ``(Q, rows, n)`` difference tensor stays bounded at the main
path's shapes; blocking changes no arithmetic (each output element is one
row's fixed-order sum).

The squared-ED kernels of ``csrc/ed.cu`` and the ``wkv6`` kernels round
differently from the direct form, so they are held to it only within a
tolerance. Bit for bit they are held to :func:`ed_matrix_fma_ref`,
:func:`ed_min_fma_ref`, :func:`wkv6_fma_ref` and :func:`wkv6_bwd_fma_ref`,
which repeat the kernels' own arithmetic (the same ``fmaf`` chains and
sums in the same order) through :func:`fmaf_ref`, a correctly rounded
float32 fused multiply-add built from float64 operations. Those run on CPU
and CUDA tensors alike and give the same bits on both (NaN payloads
aside); they are for checking, not for
serving.
"""
from __future__ import annotations

import torch

from repro_torch.core import lower_bounds as LB
from repro_torch.core import summaries as S

_BLOCK_ELEMS = 1 << 26      # elements of one (Q, rows, n) difference block
_FMA_BLOCK_ELEMS = 1 << 24  # elements of one (Q, rows) float64 fmaf block


def _row_block(q: int, width: int) -> int:
    return max(1, _BLOCK_ELEMS // max(1, q * width))


def ed_matrix_ref(queries: torch.Tensor, series: torch.Tensor) -> torch.Tensor:
    """(Q, n) x (N, n) -> (Q, N) float32 squared ED, direct-sum form."""
    q = queries.to(torch.float32)
    qn, n = q.shape
    num = series.shape[0]
    out = torch.empty((qn, num), dtype=torch.float32, device=q.device)
    step = _row_block(qn, n)
    for lo in range(0, num, step):
        s = series[lo:lo + step].to(torch.float32)
        out[:, lo:lo + s.shape[0]] = LB.squared_ed(q[:, None, :], s[None, :, :])
    return out


def ed_min_ref(queries: torch.Tensor, series: torch.Tensor,
               valid_n: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused 1-NN: ((Q,) min squared ED, (Q,) int32 argmin). Rows at or past
    ``valid_n`` never win; ties and all-inf rows resolve to the lowest index."""
    d = ed_matrix_ref(queries, series)
    if valid_n is not None:
        d[:, valid_n:] = float("inf")
    dmin, amin = torch.min(d, dim=1)
    return dmin, amin.to(torch.int32)


def fmaf_ref(a, b, c) -> torch.Tensor:
    """Correctly rounded float32 fused multiply-add ``a * b + c`` over
    broadcast float32 tensors (or numbers), as CUDA's ``fmaf`` computes it:
    one rounding, to nearest even, subnormals kept.

    The float64 product of two float32 values is exact (48 significant
    bits). Its sum with ``c`` is rounded to odd at 53 bits: the float64 sum
    ``s`` carries the exact error ``e`` of TwoSum, and where ``e != 0`` and
    ``s`` has an even significand, ``s`` steps one ulp toward ``e``. The
    cast to float32 then rounds to nearest even, and rounding to odd at 53
    bits and then to nearest at 24 is correctly rounded (53 >= 24 + 2).
    Non-finite products or addends take the plain IEEE sum."""
    dev = next(x.device for x in (a, b, c) if isinstance(x, torch.Tensor))
    a, b, c = (torch.as_tensor(x, dtype=torch.float32, device=dev).to(torch.float64)
               for x in (a, b, c))
    return _round_sum(a * b, c)


def _round_sum(p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 of ``p + c`` rounded once: ``p`` a float64 product of two
    float32 values (exact), ``c`` a float64 holding a float32 value; the
    second half of :func:`fmaf_ref`."""
    s = p + c
    bv = s - p
    e = (p - (s - bv)) + (c - bv)
    even = (s.view(torch.int64) & 1) == 0
    odd = torch.nextafter(s, torch.copysign(torch.full_like(s, float("inf")), e))
    s = torch.where((e != 0) & even, odd, s)
    return torch.where(torch.isfinite(p) & torch.isfinite(c), s, p + c).to(torch.float32)


def _fma_sq_norms(rows: torch.Tensor) -> torch.Tensor:
    """(R, n) -> (R,) squared norms, one fmaf chain per row over k
    ascending from 0.0f."""
    cols = rows.to(torch.float32).t()
    acc = torch.zeros(rows.shape[0], dtype=torch.float32, device=rows.device)
    for k in range(cols.shape[0]):
        acc = fmaf_ref(cols[k], cols[k], acc)
    return acc


def _fma_blocks(queries: torch.Tensor, series: torch.Tensor):
    """Yield (first column, (Q, rows) float32 block) of the kernels'
    squared ED, blocked over the series rows."""
    q = queries.to(torch.float32)
    qn, n = q.shape
    qt = q.t()
    q_sq = _fma_sq_norms(q)
    step = max(1, _FMA_BLOCK_ELEMS // max(1, qn))
    for lo in range(0, series.shape[0], step):
        s = series[lo:lo + step].to(torch.float32)
        st = s.t()
        acc = torch.zeros((qn, s.shape[0]), dtype=torch.float32, device=q.device)
        for k in range(n):
            acc = fmaf_ref(qt[k][:, None], st[k][None, :], acc)
        yield lo, (q_sq[:, None] + _fma_sq_norms(s)[None, :]) - 2.0 * acc


def ed_matrix_fma_ref(queries: torch.Tensor, series: torch.Tensor) -> torch.Tensor:
    """(Q, n) x (N, n) -> (Q, N) float32 squared ED in the ED kernels'
    arithmetic (``csrc/ed.cu``), bit for bit: each squared norm and each
    ``q . s`` is one ``fmaf`` chain over k ascending from 0.0f on the
    exactly widened values (bf16 -> float32), and ``out = (qn + sn) - 2 acc``
    in three float32 operations (the kernels never contract them)."""
    out = torch.empty((queries.shape[0], series.shape[0]), dtype=torch.float32,
                      device=queries.device)
    for lo, blk in _fma_blocks(queries, series):
        out[:, lo:lo + blk.shape[1]] = blk
    return out


def ed_min_fma_ref(queries: torch.Tensor, series: torch.Tensor,
                   valid_n: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused 1-NN in the ED kernels' arithmetic, bit for bit ``ed_min``'s:
    ``d + 0.0`` (so -0.0 ties +0.0) of :func:`ed_matrix_fma_ref`, +inf at or
    past ``valid_n``; the minimum, and the first index whose distance equals
    it (``torch.min``'s index is not promised for ties on CUDA); an all-inf
    row reports (inf, 0). Returns ((Q,) float32, (Q,) int32)."""
    qn, num = queries.shape[0], series.shape[0]
    valid = num if valid_n is None else int(valid_n)
    dev = queries.device
    best_d = torch.full((qn,), float("inf"), dtype=torch.float32, device=dev)
    best_i = torch.zeros((qn,), dtype=torch.int64, device=dev)
    for lo, blk in _fma_blocks(queries, series):
        cols = torch.arange(lo, lo + blk.shape[1], device=dev)
        d = torch.where(cols[None, :] < valid, blk + 0.0, float("inf"))
        low = d.amin(dim=1)
        first = torch.where(d == low[:, None], cols[None, :], num).amin(dim=1)
        take = low < best_d
        best_d = torch.where(take, low, best_d)
        best_i = torch.where(take, first, best_i)
    return best_d, best_i.to(torch.int32)


def decode_bf16_ref(payload: torch.Tensor) -> torch.Tensor:
    """(B, 2n) uint8 bfloat16 payload -> (B, n) float32 rows.

    The payload is the byte image of little-endian bfloat16 rows (the bf16
    codec's row prefix, possibly a strided view); the widening is exact."""
    num, twon = payload.shape
    return payload.contiguous().view(torch.bfloat16).reshape(num, twon // 2) \
        .to(torch.float32)


def decode_bf16_ed_matrix_ref(queries: torch.Tensor,
                              payload: torch.Tensor) -> torch.Tensor:
    """Fused decode + ED: (Q, n) x (B, 2n) uint8 -> (Q, B) float32 squared
    ED against the decoded rows, direct-sum form."""
    return ed_matrix_ref(queries, decode_bf16_ref(payload))


def lb_sax_matrix_ref(q_paa: torch.Tensor, codes: torch.Tensor, series_len: int,
                      alphabet: int = S.SAX_ALPHABET) -> torch.Tensor:
    """(Q, m) PAA x (N, m) uint8 codes -> (Q, N) squared LB_SAX (MINDIST)."""
    q = q_paa.to(torch.float32)
    qn, m = q.shape
    num = codes.shape[0]
    out = torch.empty((qn, num), dtype=torch.float32, device=q.device)
    step = _row_block(qn, m)
    for lo in range(0, num, step):
        c = codes[lo:lo + step]
        out[:, lo:lo + c.shape[0]] = LB.lb_sax(q[:, None, :], c[None, :, :],
                                               series_len, alphabet)
    return out


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
             u: torch.Tensor, state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 recurrence, a plain loop over T (``repro/kernels/ref.py::wkv6_ref``).

    r, k, w (B, T, H, K); v (B, T, H, V); u (H, K); state (B, H, K, V).
    Per step ``out_t = r_t . (S + diag(u) k_t v_t^T)`` and
    ``S = diag(w_t) S + k_t v_t^T``, all in float32; ``w == 0`` is an exact
    reset to ``k_t v_t^T`` (never ``0 * S``, which turns an overflowed state
    into NaN). Returns (out (B, T, H, V) in r's dtype, final state float32).
    """
    b, t, h, _ = r.shape
    out = torch.empty((b, t, h, v.shape[-1]), dtype=r.dtype, device=r.device)
    s = state.to(torch.float32, copy=True)
    uu = u.to(torch.float32)[None, :, :, None]
    for i in range(t):
        rt, kt = r[:, i].to(torch.float32), k[:, i].to(torch.float32)
        vt, wt = v[:, i].to(torch.float32), w[:, i].to(torch.float32)
        kv = kt[..., :, None] * vt[..., None, :]                  # (B, H, K, V)
        out[:, i] = torch.einsum("bhk,bhkv->bhv", rt, s + uu * kv).to(r.dtype)
        wd = wt[..., :, None]
        s = torch.where(wd == 0.0, kv, wd * s + kv)
    return out, s


def rg_lru_scan_ref(a: torch.Tensor, g: torch.Tensor,
                    h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU's linear scan, a plain loop over T (the ``lax.scan`` of
    ``repro/models/recurrentgemma.py::_rg_lru``).

    a, g (B, T, R) and h0 (B, R), float32. Per step ``h_t = a_t * h_{t-1} +
    g_t``: one rounded multiply, then one rounded add (no fused
    multiply-add), the arithmetic of ``csrc/rg_lru.cu`` bit for bit.
    Returns (y (B, T, R) the h_t, hT (B, R)), float32. Differentiable (the
    reference's scan is, under ``jax.grad``)."""
    h = h0
    ys = []
    for t in range(a.shape[1]):
        h = torch.add(torch.mul(a[:, t], h), g[:, t])
        ys.append(h)
    y = torch.stack(ys, 1) if ys else a.new_empty(a.shape)
    return y, h


def rg_lru_scan_bwd_ref(a: torch.Tensor, y: torch.Tensor, h0: torch.Tensor,
                        dy: torch.Tensor, dhT: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of :func:`rg_lru_scan_ref`, a plain reverse loop over T
    (the arithmetic of ``csrc/rg_lru.cu::rg_lru_scan_bwd`` bit for bit).

    a, y (the forward's output), dy (B, T, R) and h0, dhT (B, R), float32.
    With ``c = dhT`` and, for t = T-1 .. 0, ``dh_t = dy_t + c`` (one
    rounded add), ``dg_t = dh_t``, ``da_t = dh_t * h_{t-1}`` (``h_{t-1}``
    is ``y_{t-1}``, or h0 at t = 0) and ``c = a_t * dh_t`` (one rounded
    multiply): the forward's ``h_t = a_t h_{t-1} + g_t`` read backwards.
    Returns (da, dg (B, T, R), dh0 = c (B, R)), float32."""
    t_len = a.shape[1]
    da, dg = torch.empty_like(a), torch.empty_like(a)
    c = dhT.to(torch.float32, copy=True)
    for t in range(t_len - 1, -1, -1):
        dh = torch.add(dy[:, t], c)
        dg[:, t] = dh
        da[:, t] = torch.mul(dh, y[:, t - 1] if t else h0)
        c = torch.mul(a[:, t], dh)
    return da, dg, c


def wkv6_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                 u: torch.Tensor, s0: torch.Tensor, dout: torch.Tensor,
                 dsT: torch.Tensor, dtype: torch.dtype = torch.float32
                 ) -> tuple[torch.Tensor, ...]:
    """The gradient of :func:`wkv6_ref`, plain loops over T in float32 (what
    ``jax.vjp`` of ``repro/kernels/ref.py::wkv6_ref`` computes), or in
    ``dtype`` (float64: the yardstick the float32 versions are measured
    against).

    Inputs as :func:`wkv6_ref`, with dout (B, T, H, V) and dsT (B, H, K, V),
    the gradients of its two outputs. A forward loop keeps every state
    ``S_{t-1}``; then, from ``G = dsT`` backwards, per step (``G`` the
    gradient of ``S_t``, ``Gs`` it with the rows where ``w_i == 0`` zeroed,
    as the reset's select passes nothing to the earlier state):
    ``dr_t = (S_{t-1} + diag(u) k_t v_t^T) do_t``,
    ``dk_t = G v_t + u r_t (v_t . do_t)``,
    ``dv_t = G^T k_t + (sum_i u_i r_i k_i) do_t``,
    ``dw_t = rowsum(Gs * S_{t-1})`` (0 at a reset row of a finite state),
    ``du += r_t k_t (v_t . do_t)`` and ``G = diag(w_t) Gs + r_t do_t^T``.
    Returns (dr, dk, dv in r's dtype; dw (B, T, H, K), du (H, K) summed
    over the batch in order, ds0 = G; float32), every one in ``dtype`` when
    that is not float32."""
    b, t_len, h, dk = r.shape
    xs = [x.to(dtype) for x in (r, k, v, w, dout)]
    rf, kf, vf, wf, dof = xs
    uf = u.to(dtype)
    s = s0.to(dtype, copy=True)
    states = []
    for t in range(t_len):
        states.append(s)
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]          # (B, H, K, V)
        wd = wf[:, t, :, :, None]
        s = torch.where(wd == 0.0, kv, wd * s + kv)
    dr, dkk, dw = (torch.empty((b, t_len, h, dk), dtype=dtype, device=r.device)
                   for _ in range(3))
    dv = torch.empty_like(vf)
    du = torch.zeros((b, h, dk), dtype=dtype, device=r.device)
    g = dsT.to(dtype, copy=True)
    for t in range(t_len - 1, -1, -1):
        rt, kt, vt, wt, dot = (x[:, t] for x in xs)
        s_prev = states[t]
        vdo = (vt * dot).sum(-1, keepdim=True)                    # (B, H, 1)
        kv = kt[..., :, None] * vt[..., None, :]
        dr[:, t] = torch.einsum("bhkv,bhv->bhk", s_prev + uf[None, :, :, None] * kv, dot)
        dkk[:, t] = torch.einsum("bhkv,bhv->bhk", g, vt) + uf * rt * vdo
        ruk = (uf * rt * kt).sum(-1, keepdim=True)
        dv[:, t] = torch.einsum("bhkv,bhk->bhv", g, kt) + ruk * dot
        gs = torch.where(wt[..., :, None] == 0.0, torch.zeros_like(g), g)
        dw[:, t] = (gs * s_prev).sum(-1)
        du = du + rt * kt * vdo
        g = wt[..., :, None] * gs + rt[..., :, None] * dot[..., None, :]
    du_sum = du[0].clone() if b else torch.zeros((h, dk), dtype=dtype, device=r.device)
    for i in range(1, b):
        du_sum = du_sum + du[i]
    if dtype != torch.float32:
        return dr, dkk, dv, dw, du_sum, g
    return dr.to(r.dtype), dkk.to(k.dtype), dv.to(v.dtype), dw, du_sum, g


_BWD_TILE = 64      # csrc/wkv6_bwd.cu pads K and V to this


def _lane_tree(x: torch.Tensor) -> torch.Tensor:
    """(..., 2^m) -> (...): the butterfly of a warp's shuffles over lane
    masks 2^(m-1), ..., 2, 1, element e adding element e + 2^(m-1) first."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def _row_chain_tree(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., 64, 64) x (..., 64, 64) or (..., 1, 64) -> (..., 64): sum_j
    a_ij x_ij as ``csrc/wkv6_bwd.cu`` takes it: a chain over each group of
    4 columns (``a x`` rounded, then fmaf), then the 16 groups' butterfly."""
    a4 = a.unflatten(-1, (16, 4))
    x4 = x.unflatten(-1, (16, 4))
    acc = a4[..., 0] * x4[..., 0]
    for c in range(1, 4):
        acc = fmaf_ref(a4[..., c], x4[..., c], acc)
    return _lane_tree(acc)


def wkv6_bwd_fma_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                     u: torch.Tensor, s0: torch.Tensor, dout: torch.Tensor,
                     dsT: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The gradient in the ``wkv6_bwd`` kernel's arithmetic
    (``csrc/wkv6_bwd.cu``), bit for bit; arguments and results as
    :func:`wkv6_bwd_ref`.

    K and V are padded to 64 (r, k, v, do, u and the states with 0, w
    with 1). The states are the forward's (``kv = k_i v_j`` rounded, ``S =
    kv`` where ``w_i == 0``, else ``fmaf(w_i, S, kv)``). Per step, with
    ``vdo = v . do`` and ``ruk = sum_i (u_i r_i) k_i`` each a chain of two
    terms per lane (elements l and l + 32; the first a rounded product) and
    a butterfly over 32 lanes: ``dr_i = fmaf(u_i k_i, vdo, sum_j S_ij
    do_j)``, ``dk_i = fmaf(u_i r_i, vdo, sum_j G_ij v_j)``, ``dw_i = sum_j
    Gs_ij S_ij``, each sum over columns a chain per group of 4 and the 16
    groups' butterfly; ``dv_j = fmaf(ruk, do_j, sum_i G_ij k_i)``, the sum
    a chain over rows 2 g, 2 g + 1, then pairs g = 2 m, 2 m + 1 added, then
    the 16 m added in order; ``du_i = fmaf(r_i k_i, vdo, du_i)`` from 0
    over t descending, then summed over b in order; ``G = fmaf(w_i, Gs, r_i
    do_j)``. Every fmaf is :func:`fmaf_ref`'s correctly rounded one."""
    b, t_len, h, dk = r.shape
    dv = v.shape[-1]
    n = _BWD_TILE
    dev = r.device

    def pad(x, value=0.0):
        return torch.nn.functional.pad(x.to(torch.float32), (0, n - x.shape[-1]),
                                       value=value)

    rf, kf, wf = pad(r), pad(k), pad(w, 1.0)
    vf, dof = pad(v), pad(dout)
    uf = pad(u)
    s = torch.zeros((b, h, n, n), dtype=torch.float32, device=dev)
    s[..., :dk, :dv] = s0
    g = torch.zeros_like(s)
    g[..., :dk, :dv] = dsT
    states = []
    for t in range(t_len):
        states.append(s)
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        wd = wf[:, t, :, :, None]
        s = torch.where(wd == 0.0, kv, fmaf_ref(wd, s, kv))
    grads = [torch.empty((b, t_len, h, n), dtype=torch.float32, device=dev) for _ in range(4)]
    gr, gk, gw, gv = grads
    du = torch.zeros((b, h, n), dtype=torch.float32, device=dev)
    half = n // 2
    for t in range(t_len - 1, -1, -1):
        rt, kt, wt, vt, dot = (x[:, t] for x in (rf, kf, wf, vf, dof))
        sp = states[t]
        vdo = _lane_tree(fmaf_ref(vt[..., half:], dot[..., half:],
                                  vt[..., :half] * dot[..., :half]))          # (B, H)
        ur = uf * rt
        ruk = _lane_tree(fmaf_ref(ur[..., half:], kt[..., half:],
                                  ur[..., :half] * kt[..., :half]))
        gr[:, t] = fmaf_ref(uf * kt, vdo[..., None], _row_chain_tree(sp, dot[..., None, :]))
        gk[:, t] = fmaf_ref(ur, vdo[..., None], _row_chain_tree(g, vt[..., None, :]))
        gs = torch.where(wt[..., :, None] == 0.0, torch.zeros_like(g), g)
        gw[:, t] = _row_chain_tree(gs, sp)
        pair = fmaf_ref(g[..., 1::2, :], kt[..., 1::2, None],
                        g[..., 0::2, :] * kt[..., 0::2, None])               # (B, H, 32, n)
        warps = pair[..., 0::2, :] + pair[..., 1::2, :]                      # (B, H, 16, n)
        col = warps[..., 0, :]
        for m in range(1, warps.shape[-2]):
            col = col + warps[..., m, :]
        gv[:, t] = fmaf_ref(ruk[..., None], dot, col)
        du = fmaf_ref(rt * kt, vdo[..., None], du)
        g = fmaf_ref(wt[..., :, None], gs, rt[..., :, None] * dot[..., None, :])
    du_sum = du[0].clone() if b else torch.zeros((h, n), dtype=torch.float32, device=dev)
    for i in range(1, b):
        du_sum = du_sum + du[i]
    return (gr[..., :dk].to(r.dtype), gk[..., :dk].to(k.dtype), gv[..., :dv].to(v.dtype),
            gw[..., :dk].contiguous(), du_sum[:, :dk].contiguous(),
            g[..., :dk, :dv].contiguous())


_WKV_SPLIT = 4      # partial sums per state column in csrc/wkv6.cu


def wkv6_fma_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                 u: torch.Tensor, state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 recurrence in the ``wkv6`` kernel's arithmetic
    (``csrc/wkv6.cu``), bit for bit; shapes and dtypes as :func:`wkv6_ref`.

    Per step, on the exactly widened r, k, v: ``kv = k_i * v_j`` rounded to
    float32; column j's sum in 4 partials, partial p over rows i = p, p + 4,
    ... ascending, ``acc = fmaf(r_i, fmaf(u_i, kv, S_ij), acc)`` from 0.0f
    (a partial with no rows stays 0.0f); ``out_j = (acc_0 + acc_1) + (acc_2
    + acc_3)``, rounded to nearest even in a bf16 ``out``; and ``S_ij =
    kv`` where ``w_i == 0``, else ``fmaf(w_i, S_ij, kv)``. Every fmaf is
    :func:`fmaf_ref`'s correctly rounded one."""
    b, t, h, dk = r.shape
    dv = v.shape[-1]
    out = torch.empty((b, t, h, dv), dtype=r.dtype, device=r.device)
    s = state.to(torch.float32, copy=True)
    u64 = u.to(torch.float32).to(torch.float64)[None, :, :, None]
    for i in range(t):
        rt, kt, vt, wt = (x[:, i].to(torch.float32) for x in (r, k, v, w))
        kv = kt[..., :, None] * vt[..., None, :]                  # (B, H, K, V)
        inner = _round_sum(u64 * kv.double(), s.double())
        prod = rt.double()[..., :, None] * inner.double()
        acc = torch.zeros((b, h, _WKV_SPLIT, dv), dtype=torch.float32, device=r.device)
        for lo in range(0, dk, _WKV_SPLIT):
            n = min(_WKV_SPLIT, dk - lo)
            acc[:, :, :n] = _round_sum(prod[:, :, lo:lo + n], acc[:, :, :n].double())
        out[:, i] = ((acc[:, :, 0] + acc[:, :, 1]) + (acc[:, :, 2] + acc[:, :, 3])).to(r.dtype)
        wd = wt[..., :, None]
        s = torch.where(wd == 0.0, kv, _round_sum(wd.double() * s.double(), kv.double()))
    return out, s


DTW_BIG = 3.0e38        # repro/core/dtw.py's value outside the band
_DTW_BLOCK_ELEMS = 1 << 22   # (Q, rows, n + 1) elements of one wavefront buffer


def dtw_operands(query: torch.Tensor, cands: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, tuple]:
    """The (Q, n) queries and (Q, B, n) candidates of a banded-DTW call, and
    the shape of its result: a query (n,) against candidates (..., n) gives
    (...); queries (Q, n) against their own candidates (Q, B, n) give (Q, B).
    Both float32."""
    if query.ndim == 1:
        n = query.shape[0]
        if cands.ndim < 1 or cands.shape[-1] != n:
            raise ValueError(f"dtw: query {tuple(query.shape)} against candidates "
                             f"{tuple(cands.shape)}; expected (n,) x (..., n)")
        return (query.to(torch.float32).reshape(1, n),
                cands.to(torch.float32).reshape(1, -1, n), tuple(cands.shape[:-1]))
    if query.ndim != 2 or cands.ndim != 3 or cands.shape[0] != query.shape[0] \
            or cands.shape[2] != query.shape[1]:
        raise ValueError(f"dtw: queries {tuple(query.shape)} against candidates "
                         f"{tuple(cands.shape)}; expected (Q, n) x (Q, B, n)")
    return (query.to(torch.float32), cands.to(torch.float32),
            tuple(cands.shape[:2]))


def dtw_band_ref(query: torch.Tensor, cands: torch.Tensor, band: int) -> torch.Tensor:
    """Sakoe-Chiba-banded DTW with squared local costs
    (``repro/core/dtw.py::dtw_distance``); shapes as :func:`dtw_operands`.

    ``D[i][j] = c + min(D[i-1][j-1], D[i-1][j], D[i][j-1])`` for
    ``|i - j| <= band``, ``c = (b_j - a_i) * (b_j - a_i)`` rounded before the
    add, :data:`DTW_BIG` outside the band and the matrix, 0 the one
    predecessor of (0, 0); row 0 takes the same recurrence (only ``left``
    is present there), never a cumulative sum, whose parallel scan on CUDA
    would round otherwise. Every cell is one rounded add of an exact
    minimum, so the result does not depend on evaluation order: this
    anti-diagonal wavefront (2n - 1 steps, each vectorised over the band and
    the batch) equals ``csrc/dtw.cu`` row by row, bit for bit, on any
    device."""
    if band < 0:
        raise ValueError(f"dtw: band={band} must be >= 0")
    q, c, shape = dtw_operands(query, cands)
    qn, num, n = c.shape
    out = torch.empty((qn, num), dtype=torch.float32, device=c.device)
    if qn * num == 0:
        return out.reshape(shape)
    if n == 0:
        raise ValueError("dtw: series of length 0")
    band = min(band, n - 1)
    step = max(1, _DTW_BLOCK_ELEMS // (qn * (n + 1)))
    for lo in range(0, num, step):
        out[:, lo:lo + step] = _dtw_wavefront(q, c[:, lo:lo + step], band)
    return out.reshape(shape)


def _dtw_wavefront(q: torch.Tensor, c: torch.Tensor, band: int) -> torch.Tensor:
    """(Q, n) x (Q, B, n) -> (Q, B): the wavefront over anti-diagonals
    d = i + j. A buffer holds one anti-diagonal indexed by row i + 1; slot
    0 (row -1) and every cell off the band stay DTW_BIG."""
    qn, num, n = c.shape
    dev = c.device
    prev2 = torch.full((qn, num, n + 1), DTW_BIG, dtype=torch.float32, device=dev)
    prev1 = prev2.clone()
    for d in range(2 * n - 1):
        i_lo = max(0, d - (n - 1), (d - band + 1) // 2)
        i_hi = min(n - 1, d, (d + band) // 2)
        i = torch.arange(i_lo, i_hi + 1, device=dev)
        diff = c[:, :, d - i] - q[:, None, i]
        cost = diff * diff
        if d == 0:
            m = torch.zeros_like(cost)
        else:
            m = torch.minimum(torch.minimum(prev2[:, :, i], prev1[:, :, i]),
                              prev1[:, :, i + 1])       # diag, up, left
        cur = torch.full_like(prev1, DTW_BIG)
        cur[:, :, i + 1] = cost + m
        prev2, prev1 = prev1, cur
    return prev1[:, :, n]
