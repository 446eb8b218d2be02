"""The port's C++ mmap batch cache (``pfn_tpu_torch.native``) against the JAX
package's, on the CPU.

  * ``batch_cache.cpp`` is the JAX package's file byte for byte, and the
    library is built under ``build/pfn_tpu_torch/``, not in the package.
  * A round trip: zero-copy read-only views by default, copies on request.
  * A cache written by the port reads in JAX's ``BatchCacheReader``, and one
    written by JAX in the port's, bitwise.
  * The numpy fallback (no library) writes and reads an ``.npz``;
    ``open_cache`` raises where a native cache exists and the library is
    unavailable (JAX's rule), and never reads something else.
  * ``CachedPrior``: ``sample`` on a generator; ``training_iter`` feeding
    ``train(data_iter=...)`` gives, bitwise, the run fed the same batches
    from memory; ``PrefetchIterator`` keeps the stream's order and raises
    the worker's error at the consumer.
"""

import filecmp
from pathlib import Path

import numpy as np
import pytest
import torch

from pfn_tpu.native import cache as jcache
from pfn_tpu_torch.native import cache
from pfn_tpu_torch.priors import StrokePrior
from pfn_tpu_torch.train import TrainConfig, ce_criterion, train

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _records(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [{"x": rng.normal(size=(3, 5, 4)).astype(np.float32), "y": rng.normal(size=(3, 5)).astype(np.float32),
             "target_y": rng.normal(size=(3, 5)).astype(np.float32)} for _ in range(n)]


def _write(module, path, records):
    with module.BatchCacheWriter(str(path), {k: v.shape for k, v in records[0].items()}) as w:
        for r in records:
            w.append(**r)
    return w.finish()


def test_source_and_build_place():
    assert filecmp.cmp(ROOT / "pfn_tpu_torch" / "native" / "batch_cache.cpp",
                       ROOT / "pfn_tpu" / "native" / "batch_cache.cpp", shallow=False)
    assert cache.native_available()
    assert cache.library_path().parent == ROOT / "build" / "pfn_tpu_torch" and cache.library_path().exists()
    assert not list((ROOT / "pfn_tpu_torch" / "native").glob("*.so"))


def test_round_trip_zero_copy(tmp_path):
    records = _records(4)
    assert _write(cache, tmp_path / "c", records) == 4
    reader = cache.open_cache(str(tmp_path / "c"))
    assert isinstance(reader, cache.BatchCacheReader) and len(reader) == 4
    for i, want in enumerate(records):
        got = reader[i]
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert not got[k].flags.writeable and not got[k].flags.owndata  # a view into the mmap
        copied = reader.record(i, copy=True)
        assert copied["x"].flags.writeable
    with pytest.raises(IndexError):
        reader.record(4)
    reader.close()


@pytest.mark.parametrize("writer, reader", [(cache, jcache), (jcache, cache)], ids=["port_to_jax", "jax_to_port"])
def test_caches_cross_between_packages(tmp_path, writer, reader):
    records = _records(3, seed=1)
    _write(writer, tmp_path / "c", records)
    r = reader.BatchCacheReader(str(tmp_path / "c"))
    assert r.shapes == {k: v.shape for k, v in records[0].items()}
    for i, want in enumerate(records):
        for k in want:
            assert r.record(i)[k].tobytes() == want[k].tobytes()
    r.close()


def test_numpy_fallback_and_open_cache_rule(tmp_path, monkeypatch):
    _write(cache, tmp_path / "native", _records(2))
    monkeypatch.setattr(cache, "_load", lambda: None)
    assert not cache.native_available()
    records = _records(2, seed=2)
    assert _write(cache, tmp_path / "fallback", records) == 2
    r = cache.open_cache(str(tmp_path / "fallback"))
    assert isinstance(r, cache.NumpyBatchCacheReader)
    np.testing.assert_array_equal(r[1]["x"], records[1]["x"])
    with pytest.raises(RuntimeError, match="native reader is unavailable"):
        cache.open_cache(str(tmp_path / "native"))
    with pytest.raises(FileNotFoundError):
        cache.open_cache(str(tmp_path / "nothing"))


@pytest.fixture(scope="module")
def stroke_cache(tmp_path_factory):
    path = tmp_path_factory.mktemp("cache") / "stroke"
    prior = StrokePrior(num_features=16, num_outputs=2, only_train_for_last_idx=True)
    n = cache.write_prior_cache(str(path), prior, 5, 4, 7, torch.Generator().manual_seed(0))
    assert n == 5
    return path, prior


def test_write_prior_cache_and_sample(stroke_cache):
    path, prior = stroke_cache
    want = [prior.sample(4, 7, generator=g) for g in [torch.Generator().manual_seed(0)] for _ in range(5)]
    cached = cache.CachedPrior(str(path))
    assert (cached.num_features, cached.num_outputs) == (16, 1)
    for i, (x, y, t) in enumerate(want):
        rec = cached.reader[i]
        assert np.array_equal(rec["x"], x.numpy()) and np.array_equal(rec["target_y"], t.numpy())
    x, y, t = cached.sample(4, 7, generator=torch.Generator().manual_seed(1))
    assert x.shape == (4, 7, 16) and x.dtype == torch.float32 and y.shape == t.shape == (4, 7)
    assert any(torch.equal(x, w[0]) for w in want)
    with pytest.raises(ValueError, match="cache holds shape"):
        cached.sample(3, 7)


def test_training_from_the_cache_equals_training_from_memory(stroke_cache):
    path, _ = stroke_cache
    cached = cache.CachedPrior(str(path), num_outputs=2)
    cfg = TrainConfig(emsize=16, nhid=16, nlayers=1, nhead=2, bptt=7, batch_size=4, epochs=2, steps_per_epoch=3,
                      lr=1e-3, warmup_epochs=1, eval_pos_sampler="fixed", fixed_eval_pos=6, verbose=False,
                      device="cpu")
    stream = cached.training_iter(seed=3, prefetch=2)
    fed = train(cached, ce_criterion(2), cfg, data_iter=stream)
    stream.close()
    rng = np.random.RandomState(3)
    picks = [rng.randint(len(cached.reader)) for _ in range(6)]
    memory = iter([tuple(torch.from_numpy(cached.reader.record(i, copy=True)[k]) for k in ("x", "y", "target_y"))
                   for i in picks])
    ref = train(cached, ce_criterion(2), cfg, data_iter=memory)
    assert [s["mean_loss"] for s in fed.epoch_stats] == [s["mean_loss"] for s in ref.epoch_stats]
    assert all(torch.equal(a, b) for a, b in zip(fed.model.state_dict().values(), ref.model.state_dict().values()))


def test_prefetch_keeps_the_stream_and_raises_the_workers_error():
    it = cache.PrefetchIterator(iter(range(50)), depth=3)
    assert list(it) == list(range(50))

    def failing():
        yield 1
        yield 2
        raise OSError("disk gone")

    it = cache.PrefetchIterator(failing(), depth=2)
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(OSError, match="disk gone"):
        next(it)
    closed = cache.PrefetchIterator(iter(range(100)), depth=2)
    assert next(closed) == 0
    closed.close()
    with pytest.raises(StopIteration):
        next(closed)
