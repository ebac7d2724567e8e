"""Double-buffered host->device input pipeline.

Replaces the reference's ``DataLoader(num_workers=2, prefetch_factor=2)``
fork-based feed (train_1.py:51-52 etc.) with an async device-put prefetcher:
while the device executes step N, the host has already enqueued the transfer for
step N+1 (and N+2 with depth=2). ``jax.device_put`` is asynchronous, so the
"buffer" is the queue of in-flight transfers; depth controls how many batches
are kept in flight — the north-star requirement that the lifter never stalls
on host preprocessing (BASELINE.json).
"""

from __future__ import annotations

import collections
import itertools

import jax
import numpy as np

from pose3d_tpu.parallel.mesh import batch_sharding


def batch_iterator(arrays, batch_size: int, *, shuffle: bool, seed: int = 0,
                   drop_remainder: bool = True, epochs: int | None = None):
    """Yield tuples of host numpy batches from equally-long arrays.

    Batches are sliced from a (possibly shuffled) index permutation per epoch,
    mirroring the reference DataLoader(shuffle=True, drop_last default False);
    we default to drop_remainder=True because jit wants static batch shapes —
    the final partial batch of an epoch is folded into the next epoch's
    permutation.
    """
    n = len(arrays[0])
    assert all(len(a) == n for a in arrays)
    rng = np.random.default_rng(seed)
    epoch_iter = range(epochs) if epochs is not None else itertools.count()
    for _ in epoch_iter:
        idx = rng.permutation(n) if shuffle else np.arange(n)
        end = n - (n % batch_size) if drop_remainder else n
        for start in range(0, end, batch_size):
            sel = idx[start : start + batch_size]
            yield tuple(a[sel] for a in arrays)


def prefetch_to_device(iterator, mesh, depth: int = 2):
    """Asynchronously stage host batches onto the mesh, ``depth`` in flight.

    Each batch is device_put with batch-axis NamedSharding (each chip gets
    its shard directly — no replicate-then-slice) and yielded only after the
    queue is primed, overlapping H2D DMA with device compute.
    """
    sharding = batch_sharding(mesh)
    queue = collections.deque()

    def stage(host_batch):
        return jax.tree_util.tree_map(
            lambda x: jax.device_put(x, sharding), host_batch
        )

    for host_batch in iterator:
        queue.append(stage(host_batch))
        if len(queue) >= depth:
            yield queue.popleft()
    while queue:
        yield queue.popleft()
