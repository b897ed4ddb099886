"""Sums of a frame's chunks, taken on the device when the frame is
submitted and again from the file it reached, so that every frame of the
window is held to the state at its step without a copy of that state.

A chunk's bytes are read as int32 words (each chunk of a frame is of a
4-byte type) and summed modulo 2**32, so the order of the additions does
not matter: the sums of ``BLOCKS`` contiguous blocks of words, the sums
of the words by index modulo ``STRIDE`` (a prime), and the words past
the last whole block or stride as they are.  A change of any one word
changes its block's sum; two words that trade places within a block
change their stride classes' sums.
"""

import numpy as np

BLOCKS = 256
STRIDE = 257


def _cuts(m):
    """Words in whole blocks, in whole strides, and where the rest
    starts, of a chunk of ``m`` words."""
    b, q = m // BLOCKS * BLOCKS, m // STRIDE * STRIDE
    return b, q, min(b, q)


def device_sums(t):
    """The sums of the tensor ``t`` on its device, as int32 tensors
    ``(by block, by stride class, rest)``; nothing waits for them."""
    import torch

    w = t.detach().reshape(-1).view(torch.int32)
    b, q, r = _cuts(w.numel())
    return (w[:b].view(BLOCKS, b // BLOCKS).sum(1, dtype=torch.int32),
            w[:q].view(-1, STRIDE).sum(0, dtype=torch.int32),
            w[r:].clone())


def host_sums(a):
    """The same sums of the array ``a``, as int64 arrays modulo 2**32."""
    w = np.ascontiguousarray(a).reshape(-1).view(np.int32).astype(np.int64)
    b, q, r = _cuts(w.size)
    return tuple(s & 0xFFFFFFFF for s in (
        w[:b].reshape(BLOCKS, b // BLOCKS).sum(1),
        w[:q].reshape(-1, STRIDE).sum(0), w[r:]))


def as_host(sums):
    """:func:`device_sums` read back, in :func:`host_sums`' form."""
    return tuple(s.cpu().numpy().astype(np.int64) & 0xFFFFFFFF for s in sums)


def equal(a, b):
    """Two sets of sums agree."""
    return len(a) == len(b) and all(
        x.shape == y.shape and np.array_equal(x, y) for x, y in zip(a, b))
