"""Native (C++) runtime components, bound with ctypes.

Port of ``pfn_tpu/native/``: the memory-mapped batch cache
(``batch_cache.cpp``, the same file, so a cache written by either package
reads in the other), the data-loader runtime for pre-rendered prior batches.
It replaces the reference's torch.save-per-batch streaming
(priors/stroke.py:81-84) and host-RAM episode cache
(datasets/omniglotNshot.py:172-246) with one binary format served by
zero-copy mmap reads. The shared library is compiled with g++ on first use
into ``build/pfn_tpu_torch/``.
"""

from pfn_tpu_torch.native.cache import (
    BatchCacheReader,
    BatchCacheWriter,
    CachedPrior,
    NumpyBatchCacheReader,
    PrefetchIterator,
    native_available,
    open_cache,
    write_prior_cache,
)

__all__ = [
    "BatchCacheReader",
    "BatchCacheWriter",
    "CachedPrior",
    "NumpyBatchCacheReader",
    "PrefetchIterator",
    "native_available",
    "open_cache",
    "write_prior_cache",
]
