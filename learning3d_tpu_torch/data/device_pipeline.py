"""Host batches and on-device augmentation, counterpart of
``learning3d_tpu/data/device_pipeline.py``.

The host only stacks raw clouds into numpy batches (``batch_iterator``); a
worker thread copies them to the device ahead of use
(``prefetch_to_device``), and the train-time augmentation runs on the device
from a ``torch.Generator`` (``augment_classification_batch``).
"""

from __future__ import annotations

import math
import queue
import threading

import numpy as np
import torch


def batch_iterator(dataset, batch_size, *, shuffle=True, seed=0, drop_last=True, epochs=None):
    """Stacked numpy batches over an indexable dataset, in the JAX package's
    order: a permutation from ``np.random.default_rng(seed + epoch)``."""
    n = len(dataset)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = np.random.default_rng(seed + epoch).permutation(n) if shuffle else np.arange(n)
        stop = n - (n % batch_size) if drop_last else n
        for start in range(0, stop, batch_size):
            idx = order[start : start + batch_size]
            items = [dataset[int(i)] for i in idx]
            yield tuple(np.stack([it[j] for it in items]) for j in range(len(items[0])))
        epoch += 1
        if epochs is None:
            return  # single pass by default; loop externally per epoch


def to_device(batch, device):
    """A tuple of numpy arrays as tensors on ``device``: on a card through
    pinned host memory with a non-blocking copy, on the CPU as they are."""
    device = torch.device(device)
    out = []
    for a in batch:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out.append(t)
    return tuple(out)


def prefetch_to_device(iterator, put=None, size=2):
    """Background prefetch: batch assembly (the ``dataset[i]`` numpy work)
    and ``put`` (e.g. ``lambda b: to_device(b, "cuda")``) run on a worker
    thread while the main thread launches compute. ``size`` bounds the
    batches in flight. An error in the worker is raised on the consumer's
    thread."""
    q = queue.Queue(maxsize=max(size, 1))
    sentinel = object()
    errors = []

    def worker():
        try:
            for item in iterator:
                q.put(item if put is None else put(item))
        except BaseException as e:  # surfaced on the consumer thread
            errors.append(e)
        finally:
            q.put(sentinel)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is sentinel:
            if errors:
                raise errors[0]
            return
        yield item


def augment_classification_batch(points, rotate=True, jitter=True, scale=True, *, generator):
    """Train-time augmentation for classification on the points' device:
    a random rotation about z, an anisotropic scale in [0.8, 1.25) per axis
    and cloud, and Gaussian jitter (sigma 0.01) clipped at +-0.05, drawn in
    that order from ``generator`` (a ``torch.Generator`` on the points'
    device). The JAX package draws the same distributions from a PRNG key;
    the values differ."""
    B = points.shape[0]
    dev, dt = points.device, points.dtype
    if rotate:
        theta = torch.rand(B, generator=generator, device=dev, dtype=dt) * (2 * math.pi)
        c, s = torch.cos(theta), torch.sin(theta)
        zeros, ones = torch.zeros_like(c), torch.ones_like(c)
        R = torch.stack([c, -s, zeros, s, c, zeros, zeros, zeros, ones], dim=-1).reshape(B, 3, 3)
        points = torch.einsum("bij,bnj->bni", R, points)
    if scale:
        sc = 0.8 + (1.25 - 0.8) * torch.rand(B, 1, 3, generator=generator, device=dev, dtype=dt)
        points = points * sc
    if jitter:
        noise = torch.randn(points.shape, generator=generator, device=dev, dtype=dt)
        points = points + torch.clamp(0.01 * noise, -0.05, 0.05)
    return points
