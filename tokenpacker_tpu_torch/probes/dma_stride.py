"""P1: stream rate, contiguous against column-sliced (counterpart of
`scripts/probe_dma_stride.py`).

The TPU probe streamed an int8 [4096, 11008] source in 512-row chunks
through a two-slot ring, `reps` chunks a call (chunk ci is rows (ci % 8)
* 512), from a contiguous source or a column slice of a fused [4096,
22016] gate/up source at column 0 or 11008: if the slices are much
slower, the fused storage must split into contiguous planes. Its output,
a touch of one element of each ring slot, had no defined value.

`stream` streams the same chunks and returns the wrapping 32-bit sum of
every streamed 32-bit word (11008 and both offsets are multiples of 4),
read 16 bytes at a time. A source may hold copies [C, 4096, W]: chunk ci
then comes from copy (ci // 8) % C, so that the rate is not the L2's (the
source is 45 MB, the L2 50 MB; `main` rotates copies of at least 4x the
L2 and prints the one-copy, L2-resident rate beside it, labelled).

    python -m tokenpacker_tpu_torch.probes.dma_stride [reps_per_call]
"""

from __future__ import annotations

import sys

import torch

from tokenpacker_tpu_torch.ops import _build
from tokenpacker_tpu_torch.probes import (
    card,
    l2_copies,
    rate_line,
    require_card,
    stream_sum_launch,
    visits,
    wrap32,
)
from tokenpacker_tpu_torch.timing import time_ms

CK = 512
NCOLS = 11008
NROWS = 4096


def bytes_per_call(reps: int) -> int:
    """Bytes one call streams (the script's reps * CK * NCOLS)."""
    return reps * CK * NCOLS


def _copies(src: torch.Tensor) -> torch.Tensor:
    return src if src.dim() == 3 else src[None]


def stream_plain(src: torch.Tensor, col_off: int, reps: int) -> torch.Tensor:
    """int32 [1]: the wrapping sum of the 32-bit words of the `reps` chunks,
    src int8 [NROWS, W] or copies [C, NROWS, W], columns [col_off, col_off
    + NCOLS)."""
    s = _copies(src)
    words = s[:, :, col_off:col_off + NCOLS].contiguous().view(torch.int32)
    nchunks = NROWS // CK
    per = words.reshape(s.shape[0] * nchunks, -1).to(torch.int64).sum(-1).remainder(2**32)
    return wrap32(int((per.cpu() * visits(reps, s.shape[0] * nchunks)).sum()), src.device)


def stream(src: torch.Tensor, col_off: int, reps: int) -> torch.Tensor:
    """The stream's checksum, int32 [1] (see `stream_plain`): the kernel on
    a CUDA tensor (contiguous int8, col_off a multiple of 16), the plain
    version on a CPU tensor."""
    if src.device.type == "cpu":
        return stream_plain(src, col_off, reps)
    s = _copies(src)
    width = s.shape[-1]
    if (src.dtype != torch.int8 or s.shape[1] != NROWS or col_off % 16 or width % 16
            or col_off + NCOLS > width or reps < 1):
        raise ValueError(f"dma_stride.stream: src {tuple(src.shape)} {src.dtype}, col_off "
                         f"{col_off}: takes int8 [C, {NROWS}, W], W and col_off multiples of 16")
    checksum, _ = stream_sum_launch(s, col_off, width, CK * width, NROWS * width, CK, NROWS // CK,
                                    s.shape[0], NCOLS, reps, 16, 4)
    stream.launches += 1
    return checksum


stream.launches = 0


def time_case(name: str, src: torch.Tensor, col_off: int, reps: int) -> float:
    """Time a call of `reps` chunks (`timing.time_ms`: back-to-back calls),
    check its checksum against the plain version, print the rate."""
    ms = time_ms(lambda: stream(src, col_off, reps))
    ok = torch.equal(stream(src, col_off, reps), stream_plain(src, col_off, reps))
    print(rate_line(name, ms, bytes_per_call(reps),
                    f", checksum {'equals' if ok else 'DIFFERS FROM'} the plain version's"),
          flush=True)
    if not ok:
        raise SystemExit(f"{name}: the kernel's checksum differs from the plain version's")
    return ms


def main(argv: list[str] | None = None) -> None:
    args = sys.argv[1:] if argv is None else argv
    reps = int(args[0]) if args else 512
    device = require_card("dma_stride")
    _build.library()
    print(card())
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    copies = l2_copies(NROWS * NCOLS, l2)
    g = torch.Generator(device=device).manual_seed(0)
    wide = torch.randint(-127, 127, (copies, NROWS, 2 * NCOLS), dtype=torch.int8, device=device,
                         generator=g)
    narrow = torch.randint(-127, 127, (copies, NROWS, NCOLS), dtype=torch.int8, device=device,
                           generator=g)
    print(f"backend=cuda ({torch.cuda.get_device_name(0)}) reps={reps}; working set {copies} "
          f"copies x [{NROWS}, {NCOLS}] = {copies * NROWS * NCOLS / 1e6:.0f} MB against an L2 of "
          f"{l2 / 1e6:.0f} MB", flush=True)
    cases = (("contiguous [4096,11008] full-width       ", narrow, 0),
             ("column slice [*,0:11008] of [4096,22016] ", wide, 0),
             ("column slice [*,11008:] of [4096,22016]  ", wide, NCOLS))
    for name, src, off in cases:
        time_case(name, src, off, reps)
    for name, src, off in cases:
        time_case(name + " one copy, L2-resident", src[:1], off, reps)


if __name__ == "__main__":
    main()
