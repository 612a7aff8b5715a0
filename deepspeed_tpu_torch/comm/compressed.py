"""Error-feedback 1-bit compressed collectives (counterpart of
``deepspeed_tpu/comm/compressed.py``; the reference's
``runtime/comm/nccl.py:47-186``).

Each rank adds its error-feedback residual to its tensor, compresses it to
signs and one L1 scale (``scale = mean|x|``, a zero signs +1), and the
signs travel as int8 (no bit packing, as in the JAX package):

1. an all-to-all sends chunk ``j`` of every rank's signs to rank ``j``, and
   an all-gather the scales; rank ``j`` averages the chunk it serves;
2. it re-compresses that average with its server residual;
3. an all-gather brings every served chunk's signs and scale back.

Bytes a rank (``comm/collectives.py``'s count): ``M`` of signs each way and
``4 n`` of scales each way, ``2 M + 8 n`` in all, against ``8 M`` for a
dense f32 all-reduce.

The functions on a process group take this rank's row; each ``*_rows``
function takes every rank's row stacked ``(n, M)`` in one process and
returns every rank's results stacked, the same arithmetic in the same
order: the tests' and the card check's plain version.
"""
from __future__ import annotations

from typing import Tuple

import torch

from deepspeed_tpu_torch.comm import collectives


def sign_compress(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``{-1, +1}`` int8 signs (0 -> +1) and the scalar scale ``mean|x|``."""
    scale = torch.mean(torch.abs(x))
    signs = torch.where(x >= 0, 1, -1).to(torch.int8)
    return signs, scale


def decompress(signs: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return signs.float() * scale


def compressed_allreduce_compressed_out(x: torch.Tensor, worker_error: torch.Tensor,
                                        server_error: torch.Tensor, group,
                                        kind: str = "grad-exchange"):
    """One 1-bit exchange of this rank's ``x`` (``(M,)``, M a multiple of the
    group size ``n``) with its residuals ``worker_error`` (``(M,)``) and
    ``server_error`` (``(M // n,)``).  Returns the average in its compressed
    form, ``(signs (M,) int8, scales (n,) f32)`` — the same on every rank,
    ``decompress_chunks(signs, scales)`` — and this rank's new residuals."""
    n = collectives.group_size(group)
    corrected = x + worker_error
    signs, scale = sign_compress(corrected)
    new_werr = corrected - decompress(signs, scale)
    served = collectives.all_to_all(signs.reshape(n, -1), group, split_dim=0, concat_dim=0,
                                    kind=kind)  # row i: rank i's signs of this rank's chunk
    scales = collectives.all_gather(scale.reshape(1), group, kind=kind)
    avg = torch.mean(served.float() * scales[:, None], dim=0)
    corrected_srv = avg + server_error
    srv_signs, srv_scale = sign_compress(corrected_srv)
    new_serr = corrected_srv - decompress(srv_signs, srv_scale)
    all_signs = collectives.all_gather(srv_signs, group, kind=kind)
    all_scales = collectives.all_gather(srv_scale.reshape(1), group, kind=kind)
    return all_signs, all_scales, new_werr, new_serr


def compressed_allreduce(x, worker_error, server_error, group, kind: str = "grad-exchange"):
    """``(average (M,), new worker_error, new server_error)`` of one 1-bit
    exchange (the JAX package's ``compressed_allreduce_replicated``: every
    rank gets the same average)."""
    signs, scales, werr, serr = compressed_allreduce_compressed_out(
        x, worker_error, server_error, group, kind=kind)
    return decompress_chunks(signs, scales), werr, serr


def compressed_allreduce_rows_compressed_out(x_rows: torch.Tensor, worker_error: torch.Tensor,
                                             server_error: torch.Tensor):
    """:func:`compressed_allreduce_compressed_out` over every rank's row in
    one process: ``x_rows``, ``worker_error`` ``(n, M)``, ``server_error``
    ``(n, M // n)``; returns ``(signs (M,), scales (n,), worker_error (n,
    M), server_error (n, M // n))``."""
    n, m = x_rows.shape
    if m % n:
        raise ValueError(f"tensor length {m} not divisible by axis size {n}")
    corrected = x_rows + worker_error
    pairs = [sign_compress(corrected[i]) for i in range(n)]
    signs = torch.stack([s for s, _ in pairs])
    scales = torch.stack([c for _, c in pairs])
    new_werr = torch.stack([corrected[i] - decompress(signs[i], scales[i]) for i in range(n)])
    served = signs.reshape(n, n, m // n)  # [source, destination chunk, :]
    out_signs, out_scales, new_serr = [], [], []
    for j in range(n):
        avg = torch.mean(served[:, j].float() * scales[:, None], dim=0)
        corrected_srv = avg + server_error[j]
        s, c = sign_compress(corrected_srv)
        out_signs.append(s)
        out_scales.append(c)
        new_serr.append(corrected_srv - decompress(s, c))
    return (torch.cat(out_signs), torch.stack(out_scales), new_werr, torch.stack(new_serr))


def compressed_allreduce_rows(x_rows, worker_error, server_error):
    """``(average (n, M): every row the same, worker_error, server_error)``,
    the JAX package's ``compressed_allreduce`` on stacked rows."""
    signs, scales, werr, serr = compressed_allreduce_rows_compressed_out(
        x_rows, worker_error, server_error)
    n = x_rows.shape[0]
    return decompress_chunks(signs, scales)[None].expand(n, -1).clone(), werr, serr


def decompress_chunks(signs: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """The f32 vector of per-chunk sign compression: ``signs`` ``(M,)``
    int8, ``scales`` ``(n,)``, chunk ``i`` spanning ``[i M/n, (i+1) M/n)``."""
    n = scales.shape[0]
    return (signs.reshape(n, -1).float() * scales[:, None]).reshape(-1)


def compress_chunks(x: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-chunk sign compression of a flat vector: ``(signs (M,) int8,
    scales (n,))``."""
    xc = x.reshape(n, -1)
    scales = torch.mean(torch.abs(xc), dim=1)
    signs = torch.where(xc >= 0, 1, -1).to(torch.int8).reshape(-1)
    return signs, scales
