"""One-token decode attention against a KV cache (GQA, window, softcap).

Counterpart of ``repro.kernels.flash_decode``. ``lengths`` counts each
row's valid positions including the newest token (already in the
cache); position t of row b is seen when ``t < lengths[b]`` and, with
``window > 0``, ``t >= lengths[b] - window``. A row that sees no
position (``lengths[b] == 0``) gives zeros, as the TPU kernel does
(the reference's ``flash_decode_ref`` gives the mean of V there).
With ``return_lse`` each (row, query head) also gets the log-sum-exp of
the scaled (and capped) scores it saw, in float32, -inf where it saw
none: a decode whose cache's sequence is sharded over ranks merges the
ranks' partial outputs with it (``models.transformer``). The kernel
writes it from its combine pass, an instance chosen by a template flag,
so the serving calls run the same code as before.

``flash_decode`` launches a hand-written CUDA kernel
(``csrc/flash_decode.cu``, replacing the TPU kernel ``_decode_kernel``;
bound by the bytes of the valid cache) for CUDA tensors, and takes the
plain version ``flash_decode_ref`` only for CPU tensors. Two instances,
named by ``instance``:
- ``"tma"`` (``tma_instance``: bf16, D 256, G <= 8; gemma2's decode): a
  persistent grid, one block an SM, whose producer warp streams
  ``TMA_TILE``-position K and V tiles into a shared-memory ring for a
  consumer warpgroup on ``wgmma``; the valid tiles of every (batch row,
  KV head) laid end to end are cut into equal contiguous ranges, one a
  consumer (``tma_split`` is its plain model), each row segment a
  partial, merged by a combine pass in a fixed order;
- ``"pieces"`` (every other shape): split-K over pieces of
  ``piece_length`` positions of each row's valid range, walked by a
  persistent grid of warps on ``mma.sync`` (bf16) or FMAs (f32), then a
  combine pass.
A shape rule, not a fallback: a call it sends to an instance launches
that instance or raises. The kernel takes bf16 or f32, D of 16, 32, 64,
128 or 256, and up to 8 query heads per KV head; a head narrower than 16
is zero-padded to 16 and the output cut back, as ``flash_attention``
does.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels._build import (fake_launch, is_fake,
                                        library_function, misaligned,
                                        refuse_grad)
from repro_torch.kernels.flash_attention import MIN_HEAD_DIM, pad_head_dim

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GROUP = 8
MIN_PIECE = 32                  # positions: a piece is whole 32-row tiles
TMA_TILE = 64                   # positions: a tile of the TMA instance
NEG_INF = -2.0e38
_INSTANCES = {"pieces": 0, "tma": 1}


def tma_instance(G: int, D: int, dtype: torch.dtype) -> bool:
    """Whether a call takes the TMA-fed ``wgmma`` instance: bf16, D 256
    (gemma2's heads, with or without its window and softcap) and G <= 8
    query heads per KV head, which are the narrow N side of its
    products. ``flash_decode_launch`` in ``csrc/flash_decode.cu`` refuses
    the instance for any other shape."""
    return dtype == torch.bfloat16 and D == 256 and 1 <= G <= MAX_GROUP


def instance(G: int, D: int, dtype: torch.dtype) -> str:
    """The instance a call launches: ``"tma"`` where ``tma_instance``
    takes it, else ``"pieces"``. D is the kernel's (a padded head's)."""
    return "tma" if tma_instance(G, D, dtype) else "pieces"


def tma_slots(B: int, Hkv: int, consumers: int) -> int:
    """Partials the TMA instance can write: one for each row segment a
    consumer touches. A consumer's tiles are contiguous in row order, so
    segment (row r, consumer w) takes slot r + w, and no two segments
    share one (``tma_split``)."""
    return B * Hkv + consumers


def tma_consumers() -> int:
    """Consumer warpgroups of the TMA instance on the current card (one
    block an SM)."""
    n = library_function("flash_decode", "flash_decode_tma_consumers",
                         [])()
    if n <= 0:
        raise RuntimeError(f"flash_decode_tma_consumers failed: "
                           f"cudaError {-n}")
    return n


def _row_range(length: int, L: int, window: int) -> Tuple[int, int]:
    hi = min(max(int(length), 0), L)
    lo = min(max(int(length) - window, 0), hi) if window > 0 else 0
    return lo, hi


def tma_split(lengths, L: int, Hkv: int, window: int, consumers: int,
              unit_tiles: int = 1) -> List[List[Tuple[int, int, int, int]]]:
    """Plain model of the TMA instance's split, for the tests: the valid
    positions [lo, hi) of each (batch row, KV head), in row order, cut
    into ``TMA_TILE``-position tiles (only a row's last tile is short),
    grouped in units of ``unit_tiles`` tiles within a row, and the units
    laid end to end; consumer w takes units [w U / W, (w + 1) U / W).
    Returns, per consumer, its segments as (slot, row, first position,
    end position), the row ``b * Hkv + hk`` and the slot ``row + w``, as
    the kernel walks them."""
    rows = []                               # (row, lo, hi, tiles)
    for b, length in enumerate(lengths):
        lo, hi = _row_range(length, L, window)
        tiles = -(-(hi - lo) // TMA_TILE)
        rows += [(b * Hkv + hk, lo, hi, tiles) for hk in range(Hkv)]
    units = [(r, lo, hi, u, tiles) for r, lo, hi, tiles in rows
             for u in range(-(-tiles // unit_tiles))]
    U = len(units)
    out = []
    for w in range(consumers):
        segs = {}
        for r, lo, hi, u, tiles in units[w * U // consumers:
                                         (w + 1) * U // consumers]:
            beg = lo + u * unit_tiles * TMA_TILE
            end = min(lo + min((u + 1) * unit_tiles, tiles) * TMA_TILE, hi)
            if r in segs:
                segs[r][3] = end
            else:
                segs[r] = [r + w, r, beg, end]
        out.append([tuple(s) for s in segs.values()])
    return out


def tma_merge_ref(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, lengths, *, window: int = 0,
                  softcap: float = 0.0, sm_scale: Optional[float] = None,
                  consumers: int):
    """Plain model of the TMA instance's two passes, for the tests: each
    segment of ``tma_split`` as a partial (its max in log2 units, its
    denominator, its unnormalised output, float32), and each row's
    partials merged in consumer order as the combine pass merges them.
    Returns (o in float32, lse), zeros and -inf for a row that sees no
    position."""
    B, L, Hkv, D = k_cache.shape
    Hq = q.shape[1]
    G = Hq // Hkv
    if sm_scale is None:
        sm_scale = D ** -0.5
    log2e = 1.4426950408889634
    qg = q.reshape(B, Hkv, G, D).to(torch.float32)
    kf, vf = k_cache.to(torch.float32), v_cache.to(torch.float32)
    parts = {}
    for segs in tma_split([int(x) for x in lengths], L, Hkv, window,
                          consumers):
        for slot, r, beg, end in segs:
            b, hk = divmod(r, Hkv)
            s = qg[b, hk] @ kf[b, beg:end, hk].T * sm_scale    # (G, n)
            if softcap > 0.0:
                s = softcap * torch.tanh(s / softcap)
            s = s * log2e
            m = s.max(dim=1).values
            p = torch.exp2(s - m[:, None])
            parts.setdefault(r, []).append(
                (slot, m, p.sum(dim=1), p @ vf[b, beg:end, hk]))
    o = torch.zeros((B * Hkv, G, D), dtype=torch.float32)
    lse = torch.full((B * Hkv, G), float("-inf"))
    for r, ps in parts.items():
        mx = torch.full((G,), float("-inf"))
        den = torch.zeros(G)
        num = torch.zeros((G, D))
        for _, m, l, acc in sorted(ps, key=lambda x: x[0]):
            m_new = torch.maximum(mx, m)
            corr, w = torch.exp2(mx - m_new), torch.exp2(m - m_new)
            den = den * corr + l * w
            num = num * corr[:, None] + acc * w[:, None]
            mx = m_new
        o[r] = num / den[:, None]
        lse[r] = mx * 0.6931471805599453 + torch.log(den)
    return o.reshape(B, Hq, D), lse.reshape(B, Hq)


def flash_decode_ref(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     window: int = 0, softcap: float = 0.0,
                     sm_scale: Optional[float] = None,
                     return_lse: bool = False):
    """Plain version: the reference's ``kernels.ref.flash_decode_ref`` in
    float32, except that a row with no visible position gives zeros (and
    an lse of -inf)."""
    B, L, Hkv, D = k_cache.shape
    Hq = q.shape[1]
    G = Hq // Hkv
    if sm_scale is None:
        sm_scale = D ** -0.5
    qg = q.reshape(B, Hkv, G, D).to(torch.float32)
    s = torch.einsum("bhgd,bthd->bhgt", qg,
                     k_cache.to(torch.float32)) * sm_scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(L, device=q.device)
    lens = lengths.to(torch.int64)[:, None]
    ok = pos[None, :] < lens
    if window > 0:
        ok &= pos[None, :] > lens - 1 - window
    s = s.masked_fill(~ok[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1) * ok.any(-1)[:, None, None, None]
    o = torch.einsum("bhgt,bthd->bhgd", p, v_cache.to(torch.float32))
    o = o.reshape(B, Hq, D).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.logsumexp(s, dim=-1).reshape(B, Hq)
    return o, torch.where(ok.any(-1)[:, None], lse,
                          torch.full_like(lse, float("-inf")))


def piece_length(B: int, Hkv: int, L: int, dtype: torch.dtype,
                 D: int) -> int:
    """Positions per piece of a row's valid range for this shape on the
    current card (a multiple of 32, at most 256): about two pieces per
    resident warp if every row were full."""
    n = library_function("flash_decode", "flash_decode_piece_len",
                         [ctypes.c_int] * 5)(B, Hkv, L, _DTYPES[dtype], D)
    if n <= 0:
        raise RuntimeError(f"flash_decode_piece_len failed: cudaError {-n}")
    return n


def _check(q, k_cache, v_cache, lengths) -> None:
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"q must be (B,Hq,D) and the caches (B,L,Hkv,D); "
                         f"got {tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    B, L, Hkv, D = k_cache.shape
    if q.shape[0] != B or q.shape[2] != D or q.shape[1] % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not match the cache "
                         f"{tuple(k_cache.shape)}")
    if lengths.shape != (B,):
        raise ValueError(f"lengths must be ({B},), got "
                         f"{tuple(lengths.shape)}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must share q's dtype and device")
    if lengths.device != q.device:
        raise ValueError("lengths must be on q's device")


def cost(B: int, Hq: int, Hkv: int, D: int, size: int, seen: int,
         return_lse: bool = False):
    """(operations, bytes) of one call that sees ``seen`` cache positions
    in all its rows: the k and v rows of those positions read, q read, o
    written, the lengths and, with ``return_lse``, the lse; QK^T and PV
    over them for every query head. A card run counts the positions its
    lengths leave visible, a trace (whose lengths are data) every
    position of the cache."""
    flops = 4 * seen * Hq * D
    n_bytes = (seen * Hkv * D * 2 * size + 2 * B * Hq * D * size + 4 * B
               + (4 * B * Hq if return_lse else 0))
    return flops, n_bytes


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, lengths: torch.Tensor, *,
                 window: int = 0, softcap: float = 0.0,
                 sm_scale: Optional[float] = None,
                 return_lse: bool = False, kernel: Optional[str] = None):
    """q: (B, Hq, D); caches: (B, L, Hkv, D); lengths: (B,) int32.
    Returns (B, Hq, D) in q's type, and with ``return_lse`` also the
    (B, Hq) float32 log-sum-exp of the module note.

    CUDA tensors launch the kernel instance that ``instance`` names
    (counted in ``flash_decode.launches``, once per call, and in
    ``flash_decode.by_instance``); ``kernel`` forces one (``"pieces"``,
    or ``"tma"`` where ``tma_instance`` allows it), so that a timing can
    compare the two on one call's inputs. CPU tensors take the plain
    version. Fake tensors pass the launch's checks and report ``cost``
    instead of launching.
    """
    _check(q, k_cache, v_cache, lengths)
    fake = is_fake(q, k_cache, v_cache, lengths)
    if q.device.type == "cpu" and not fake:
        return flash_decode_ref(q, k_cache, v_cache, lengths, window=window,
                                softcap=softcap, sm_scale=sm_scale,
                                return_lse=return_lse)
    if q.device.type != "cuda" and not fake:
        raise ValueError(f"flash_decode runs on cuda or cpu, not {q.device}")
    refuse_grad("flash_decode", q, k_cache, v_cache)
    B, L, Hkv, D = k_cache.shape
    G = q.shape[1] // Hkv
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_decode takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if sm_scale is None:
        sm_scale = D ** -0.5
    if D < MIN_HEAD_DIM:
        qp, kp, vp = pad_head_dim(q, k_cache, v_cache)
        out = flash_decode(qp, kp, vp, lengths, window=window,
                           softcap=softcap, sm_scale=sm_scale,
                           return_lse=return_lse, kernel=kernel)
        if return_lse:
            return out[0][..., :D].contiguous(), out[1]
        return out[..., :D].contiguous()
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_decode takes D in {_HEAD_DIMS}, got {D}")
    if G > MAX_GROUP:
        raise ValueError(f"flash_decode takes up to {MAX_GROUP} query heads "
                         f"per KV head, got {G}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"lengths must be int32, got {lengths.dtype}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if misaligned(t):                # 16-byte chunks and TMA boxes
            raise ValueError(f"{name} must be 16-byte aligned")
    inst = instance(G, D, q.dtype) if kernel is None else kernel
    if inst not in _INSTANCES or (inst == "tma"
                                  and not tma_instance(G, D, q.dtype)):
        raise ValueError(f"flash_decode has no {inst!r} instance for "
                         f"G={G}, D={D}, {q.dtype}")
    if inst == "tma":
        # one partial a row segment of a consumer (one an SM of the card;
        # a trace allocates nothing)
        piece = 0
        slots = tma_slots(B, Hkv, 0 if fake else tma_consumers())
    else:
        # the piece length is the card's (its SM count); a trace takes
        # the shortest, which gives the most pieces a card could need
        piece = MIN_PIECE if fake else piece_length(B, Hkv, L, q.dtype, D)
        slots = B * Hkv * -(-L // piece)
    if max(slots, B * q.shape[1]) >= 2 ** 31:
        raise ValueError(f"flash_decode takes fewer than 2**31 partials and "
                         f"(row, head) pairs, got B={B}, Hkv={Hkv}, "
                         f"{slots} partials")
    if fake:
        fake_launch("flash_decode", *cost(B, q.shape[1], Hkv, D,
                                          q.element_size(), B * L,
                                          return_lse))
        o = torch.empty_like(q)
        return (o, torch.empty(q.shape[:2], dtype=torch.float32,
                               device=q.device)) if return_lse else o
    fn = library_function(
        "flash_decode", "flash_decode_launch",
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
           ctypes.c_void_p])
    dev = q.device
    # the partial state (max, denominator, unnormalised output) of every
    # slot the instance can write
    part_ml = torch.empty((2, slots, G), dtype=torch.float32, device=dev)
    part_acc = torch.empty((slots, G, D), dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=dev) \
        if return_lse else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             lengths.data_ptr(), part_ml[0].data_ptr(), part_ml[1].data_ptr(),
             part_acc.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr(), B, L, Hkv, G, D, piece,
             slots, _DTYPES[q.dtype], float(sm_scale), int(window),
             float(softcap), _INSTANCES[inst], stream)
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: "
                           f"cudaError {err}")
    flash_decode.launches += 1
    flash_decode.by_instance[inst] += 1
    return (out, lse) if return_lse else out


flash_decode.launches = 0
# the same launches by the instance that ran them (``instance``)
flash_decode.by_instance = {"tma": 0, "pieces": 0}
