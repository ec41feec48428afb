"""Corpus and query generator of the benchmark, made on the device from the
seed.

The corpus is a mixture of ``modes`` modes.  Mode m has a centre
``c_m ~ N(0, center_scale^2 I_D)`` and an orthonormal basis ``U_m`` of a
random ``intrinsic_dim``-dimensional subspace; a point of mode m is
``c_m + U_m z + noise * e`` with ``z ~ N(0, I_r)`` and ``e ~ N(0, I_D)``.
Real embedding corpora (SIFT and GIST among them) have a local intrinsic
dimension far below D, which is what lets a clustering index reach high
recall with few probes; isotropic Gaussian modes of full dimension do not.

A query is drawn the same way and then perturbed inside its mode's
subspace, ``z + query_shift * z'``, before the ambient noise.

The modes, the corpus's points and LLSP's logged training queries come
from the configuration's ``data_seed``: like SIFT1M, the data set is one
set of vectors.  The run's seed draws the served queries afresh, and a
traffic mix may let it permute the corpus's rows too (ids, build chunks
and splits then differ from seed to seed).  So every seed does the same
amount of work: a seed that drew its own modes and training queries moved
LLSP's mean probe count, and the throughput with it, by 6% between two
seeds, and one that permuted the rows of a served index by 9%.

All draws come from ``torch.Generator`` objects on the device, in one call
per mode and array, in float32.
"""
from __future__ import annotations

import hashlib

import torch


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream ``tag`` of run ``seed`` (any integer)."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def generator(seed: int, tag: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(subseed(seed, tag))
    return g


def _counts(n: int, modes: int) -> list[int]:
    return [n // modes + (m < n % modes) for m in range(modes)]


def _modes(gen: dict, dim: int, device, seed: int):
    """(centres (M, D), bases (M, D, r)) of the mixture of run ``seed``."""
    m, r = int(gen["modes"]), int(gen["intrinsic_dim"])
    g = generator(seed, "modes", device)
    centres = torch.randn(m, dim, generator=g, device=device) \
        * float(gen["center_scale"])
    raw = torch.randn(m, dim, r, generator=g, device=device)
    bases, _ = torch.linalg.qr(raw)
    return centres, bases


def _mixture(n: int, gen: dict, dim: int, device, values_seed: int,
             order_seed: int, tag: str, shift: float) -> torch.Tensor:
    """``n`` points of the mixture of ``gen["data_seed"]``: their draws
    from ``values_seed``, their row order from ``order_seed``."""
    centres, bases = _modes(gen, dim, device, int(gen["data_seed"]))
    m, r = bases.shape[0], bases.shape[2]
    g = generator(values_seed, tag, device)
    out = torch.empty(n, dim, dtype=torch.float32, device=device)
    order = torch.randperm(n, generator=generator(order_seed, f"{tag}:order",
                                                  device), device=device)
    lo = 0
    for mode, cnt in enumerate(_counts(n, m)):
        z = torch.randn(cnt, r, generator=g, device=device)
        if shift:
            z += shift * torch.randn(cnt, r, generator=g, device=device)
        pts = torch.addmm(centres[mode].expand(cnt, dim), z,
                          bases[mode].T)
        pts.add_(torch.randn(cnt, dim, generator=g, device=device),
                 alpha=float(gen["noise"]))
        out.index_copy_(0, order[lo:lo + cnt], pts)
        lo += cnt
    return out


def corpus(n: int, dim: int, gen: dict, order_seed: int, device
           ) -> torch.Tensor:
    """(n, dim) float32 corpus: the one set of points of
    ``gen["data_seed"]`` (a data set, as SIFT1M is one), its rows in the
    order of ``order_seed``."""
    return _mixture(n, gen, dim, device, int(gen["data_seed"]), order_seed,
                    "corpus", 0.0)


def queries(n: int, dim: int, gen: dict, seed: int, device,
            tag: str = "pool") -> torch.Tensor:
    """(n, dim) float32 queries of the stream ``tag``: "pool", the served
    queries, drawn afresh from run ``seed``; "train", LLSP's logged
    queries, which belong to the data set."""
    s = seed if tag == "pool" else int(gen["data_seed"])
    return _mixture(n, gen, dim, device, s, s, tag,
                    float(gen["query_shift"]))
