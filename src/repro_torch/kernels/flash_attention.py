"""CUDA kernel: flash attention (causal / GQA / sliding window / q_offset).

The port of the Pallas TPU kernel ``repro.kernels.flash_attention.
flash_attention``. It carries the backbone's attention on the card: the
serving path's prefill and decode steps against the KV cache, and the
frozen-backbone forwards of the analytic trainer.

The kernel is ``csrc/flash_attention.cu`` (its header states the design and
the bound on an H100). ``kernels.build`` compiles it with ``nvcc`` for
``sm_90a`` on first use and ``ctypes`` binds it. ``kernels.ops.
flash_attention`` dispatches between this wrapper (CUDA tensors) and the
plain version ``kernels.ref.mha_ref`` (CPU tensors).

Unlike the Pallas kernel, ``causal``, ``window``, ``q_offset`` and the key
length are runtime arguments of one compiled kernel, and the tile sizes
(``block_q`` / ``block_k`` there) are the kernel's own compile-time choice.
The inputs are read through their strides (the head dim must be
contiguous), so the transposed head views of ``models.layers`` go in
without a copy. The output is allocated position-major, ``(B, Sq, Hq, D)``,
and returned as its ``(B, Hq, Sq, D)`` view, so that merging the heads
afterwards is free.

With ``group · Sq <= DECODE_MAX_ROWS`` (a decode step) the kernel splits the
keys: :func:`decode_plan` cuts the band of visible keys into chunks, one
block each, whose partials go to a workspace this wrapper allocates and a
second kernel merges (``ref.mha_split_ref`` is the plain twin of that
schedule). ``flash_attention.launches`` counts wrapper calls,
``flash_attention.cuda_launches`` the kernels they launched.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch.device import sm_count
from repro_torch.kernels import build as _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
MAX_HEAD_DIM = 256       # the largest head-dim template (D in {64, 128, 256})

# rows (group · Sq) up to which a call is a split-KV decode (the kernel's kDecodeMaxRows)
DECODE_MAX_ROWS = 16
SPLIT_BLOCKS_PER_SM = 2  # a decode grid fills each SM at least this many times over
SPLIT_STEP = 4           # keys a decode warp takes at a time: chunks are multiples of it
SPLIT_MIN_CHUNK = 16     # the 4 warps' first step: no chunk is shorter

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 5 + [_I] * 6 + [ctypes.c_float] + [_I] * 9 + [_P, _P]
_INT_MAX = 2**31 - 1


@functools.cache
def build() -> _build.Build:
    """Compile ``csrc/flash_attention.cu`` (once per source content), load
    it and declare its entry points."""
    built = _build.load(SOURCE)[0]
    for name in ("afl_flash_attention_f32", "afl_flash_attention_bf16"):
        fn = getattr(built.lib, name)
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return built


def _vector_loads(ts, d: int) -> bool:
    """Whether every row starts on a 4-element boundary the kernel may load
    in one instruction (16 bytes of f32, 8 of bf16)."""
    align = 4 * ts[0].element_size()
    return d % 4 == 0 and all(
        t.data_ptr() % align == 0 and all(s % 4 == 0 for s in t.stride()[:3]) for t in ts)


def decode_plan(b: int, hkv: int, sq: int, skv: int, *, causal: bool, window: Optional[int],
                q_offset: int, sms: int) -> tuple[int, int, int, int]:
    """(lo, hi, chunk, splits) of a split-KV decode: the keys ``[lo, hi)``
    that some query row sees, from the first visible to the last, cut into
    ``splits`` chunks of ``chunk`` keys (the last one shorter), so that the
    ``splits · b · hkv`` blocks fill each of ``sms`` SMs at least
    ``SPLIT_BLOCKS_PER_SM`` times where the band is long enough. An empty
    band is one empty chunk: the kernel writes zeros."""
    lo = 0 if window is None else max(0, q_offset - window + 1)
    hi = min(skv, q_offset + sq) if causal else skv
    if hi <= lo:
        return 0, 0, SPLIT_MIN_CHUNK, 1
    want = -(-SPLIT_BLOCKS_PER_SM * sms // (b * hkv))
    chunk = -(-(hi - lo) // want)
    chunk = max(SPLIT_MIN_CHUNK, -(-chunk // SPLIT_STEP) * SPLIT_STEP)
    return lo, hi, chunk, -(-(hi - lo) // chunk)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None, q_offset: int = 0) -> torch.Tensor:
    """Attention of ``q (B, Hq, Sq, D)`` over ``k, v (B, Hkv, Skv, D)`` through
    the CUDA kernel, with the semantics of ``kernels.ref.mha_ref``.

    Query head ``h`` reads kv head ``h // (Hq // Hkv)``; query row ``s``
    sits at position ``q_offset + s`` and sees key ``j`` when ``j <= q_offset
    + s`` (``causal``) and ``j > q_offset + s - window`` (``window`` not
    None); a row that sees no key is zeros. f32 or bf16 CUDA tensors of one
    type on one device, ``D <= 256`` with the last dim contiguous; the
    result has the inputs' type. Launches on the current stream;
    ``flash_attention.launches`` counts the calls that launched,
    ``flash_attention.cuda_launches`` their kernels (two for a decode split
    over several chunks, else one).
    """
    if not (q.is_cuda and k.is_cuda and v.is_cuda) or len({q.device, k.device, v.device}) != 1:
        raise ValueError(
            f"flash_attention kernel needs q, k, v on one CUDA device, got {q.device}, "
            f"{k.device}, {v.device} (kernels.ops.flash_attention takes the plain "
            "version for CPU tensors)")
    if q.dtype not in (torch.float32, torch.bfloat16) or not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"flash_attention kernel takes f32 or bf16 of one type, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention kernel needs q (B, Hq, Sq, D) and k, v "
                         f"(B, Hkv, Skv, D), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention kernel: q {tuple(q.shape)} does not match "
                         f"k, v {tuple(k.shape)} (Hq must be a multiple of Hkv)")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes head dims 1..{MAX_HEAD_DIM}, got {d}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention kernel needs the head dim contiguous (stride 1)")
    scale = d ** -0.5 if scale is None else float(scale)
    o = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    if o.numel() == 0:
        return o
    if skv == 0:
        return o.zero_()
    if max(hq * sq, skv, abs(int(q_offset)) + sq + skv) > _INT_MAX:
        raise ValueError(f"flash_attention kernel: lengths out of range (Hq·Sq={hq * sq}, "
                         f"Skv={skv}, q_offset={q_offset})")
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, o) for s in t.stride()[:3]))
    lib = build().lib
    fn = lib.afl_flash_attention_f32 if q.dtype == torch.float32 else lib.afl_flash_attention_bf16
    # a window wider than every row's position masks nothing
    has_window = window is not None and int(window) <= int(q_offset) + sq
    window = int(window) if has_window else None
    split = (0, 0, 0, 1)
    ws = None
    if hq // hkv * sq <= DECODE_MAX_ROWS:
        split = decode_plan(b, hkv, sq, skv, causal=bool(causal), window=window,
                            q_offset=int(q_offset), sms=sm_count(q.device.index))
        if split[3] > 1:
            ws = torch.empty(split[3] * b * hq * sq * (d + 2), dtype=torch.float32,
                             device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), strides,
                 b, hq, hkv, sq, skv, d, scale, int(bool(causal)), int(has_window),
                 window or 0, int(q_offset), int(_vector_loads((q, k, v), d)),
                 *split, None if ws is None else ws.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed with CUDA error {err}")
    flash_attention.launches += 1
    flash_attention.cuda_launches += 2 if ws is not None else 1
    return o


flash_attention.launches = 0
flash_attention.cuda_launches = 0
