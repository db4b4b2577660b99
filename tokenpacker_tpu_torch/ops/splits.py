"""The split-K plan of the port's cluster kernels.

K6 (`q4_matmul`), K7 (`s8_matmul`) and K4's four GEMVs (`fused_decode`)
split the K rows of each column tile over the blocks of one thread-block
cluster and sum the splits in split order in shared memory; K3 and K5
split their keys over a cluster the same way. `cluster_splits` is the
GEMVs' one plan: K6's and K7's wrappers pass it to their kernels, K4's
kernel computes it in its host code (`fused_decode.cu:gemv_splits`),
which a card test holds to this one (`fused_decode.step_plan`).
"""

from __future__ import annotations

import functools

import torch

MAX_SPLITS = 8  # the portable cluster size
STAGE_ROWS = 64  # K rows a stage of the GEMVs' rings (K6: a quantization block)


@functools.cache
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def cluster_splits(k: int, tiles: int, sms: int = 132) -> int:
    """The blocks that share one column tile's K: a power of two up to
    MAX_SPLITS, doubled while the grid of `tiles` tiles holds fewer than
    two blocks an SM, as long as each split keeps a STAGE_ROWS-row stage.
    The kernels hand each split whole stages, balanced."""
    stages = -(-k // STAGE_ROWS)
    splits = 1
    while splits < MAX_SPLITS and 2 * splits <= stages and tiles * splits < 2 * sms:
        splits *= 2
    return splits
