"""The port's host feed against the JAX package's on the CPU: the
synthetic twins, the native alias table, the samplers and the loader's
host batches, bit for bit.

Host batches are compared before the copy to a device: the JAX loader's
``_host_batches`` with its bf16 transfer cast (``ml_dtypes``) applied
against the port's ``_host_batches`` (the cast done by torch), bf16 keys
compared as 16-bit views.
"""

import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import multimodal_clinical_tpu.utils.native as jax_native
from multimodal_clinical_tpu.data import core as jax_core
from multimodal_clinical_tpu.data import loader as jax_loader
from multimodal_clinical_tpu.data import sampler as jax_sampler
from multimodal_clinical_tpu.data import synthetic as jax_synthetic

from multimodal_clinical_tpu_torch.data import core, loader, sampler, synthetic
from multimodal_clinical_tpu_torch.utils import native

torch.set_num_threads(2)

SHAPES = [(9, 12, 1), (2, 6, 6, 3)]
PAIRS = [(0, 0), (5, 3)]  # (seed, epoch)


class _WaveDataset(core.ArrayDataset):
    """The raw-waveform layout (``x1_waveform`` stays f32 on the way)."""

    def gather(self, indices):
        out = super().gather(indices)
        out["x1_waveform"] = out.pop("x1")
        return out


class _JaxWaveDataset(jax_core.ArrayDataset):
    def gather(self, indices):
        out = super().gather(indices)
        out["x1_waveform"] = out.pop("x1")
        return out


@pytest.fixture(autouse=True)
def library(monkeypatch):
    """Whether ``native/libfastdata.so`` loads, decided once for both
    bindings: the JAX binding runs ``make -C native`` first, then the port
    loads whatever is there."""
    have = jax_native.available()
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native.available() == have
    return have


@pytest.mark.parametrize("name,shapes", [("vggsound", SHAPES),
                                         ("fakenews", None),
                                         ("mimic", None)])
def test_synthetic_splits_equal_jax(name, shapes):
    got = synthetic.make_synthetic_splits(name, 7, seed=3, n_train=20,
                                          n_val=9, n_test=5, shapes=shapes)
    want = jax_synthetic.make_synthetic_splits(name, 7, seed=3, n_train=20,
                                               n_val=9, n_test=5,
                                               shapes=shapes)
    for split, jsplit in zip(got, want):
        idx = np.arange(len(jsplit))
        a, b = split.gather(idx), jsplit.gather(idx)
        assert a.keys() == b.keys()
        for k in b:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_benchmark_shapes_equal_jax():
    assert synthetic.BENCHMARK_SHAPES == jax_synthetic.BENCHMARK_SHAPES
    assert synthetic.TOKEN_MODALITIES == jax_synthetic.TOKEN_MODALITIES


@pytest.mark.parametrize("seed,epoch,index", [(0, 0, 0), (7, 3, 11),
                                              (2 ** 33, -1, 5)])
def test_sample_rng_equals_jax(seed, epoch, index):
    np.testing.assert_array_equal(
        core.sample_rng(seed, epoch, index).integers(0, 1 << 30, 8),
        jax_core.sample_rng(seed, epoch, index).integers(0, 1 << 30, 8))


def test_alias_table_equals_jax(library):
    """Both bindings of the library build one table and draw one stream;
    where it does not load, both refuse to build a table."""
    w = np.random.default_rng(0).uniform(0.1, 2.0, 50)
    if not library:
        for module in (native, jax_native):
            with pytest.raises(RuntimeError):
                module.AliasTable(w)
        return
    table, jtable = native.AliasTable(w), jax_native.AliasTable(w)
    np.testing.assert_array_equal(table.prob, jtable.prob)
    np.testing.assert_array_equal(table.alias, jtable.alias)
    np.testing.assert_array_equal(table.sample(300, seed=9),
                                  jtable.sample(300, seed=9))


def test_native_binding_reports_unavailable_on_os_error(monkeypatch):
    def refuse(path):
        raise OSError(f"{path}: cannot open shared object file")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native.ctypes, "CDLL", refuse)
    assert not native.available()
    with pytest.raises(RuntimeError, match="does not load"):
        native.AliasTable(np.ones(3))


def _labels():
    return np.random.default_rng(1).integers(0, 5, 37)


@pytest.mark.parametrize("seed,epoch", PAIRS)
@pytest.mark.parametrize("stream", ["native", "numpy"])
def test_weighted_sampler_equals_jax(seed, epoch, stream, monkeypatch,
                                    library):
    """The alias table's stream where the library loads, and numpy's,
    forced on both sides by making the library unavailable."""
    if stream == "numpy":
        monkeypatch.setattr(jax_native, "available", lambda: False)
        monkeypatch.setattr(native, "available", lambda: False)
    got = sampler.WeightedSampler(_labels(), seed=seed)
    want = jax_sampler.WeightedSampler(_labels(), seed=seed)
    native_stream = stream == "native" and library
    assert (got._alias is not None) == (want._alias is not None) == (
        native_stream)
    np.testing.assert_array_equal(got.indices(epoch), want.indices(epoch))
    assert len(got) == len(want) == 37


@pytest.mark.parametrize("seed,epoch", PAIRS)
@pytest.mark.parametrize("process_index,process_count", [(0, 1), (1, 3)])
def test_random_and_sequential_samplers_equal_jax(seed, epoch, process_index,
                                                 process_count):
    proc = dict(process_index=process_index, process_count=process_count)
    for got, want in (
            (sampler.RandomSampler(37, seed=seed, **proc),
             jax_sampler.RandomSampler(37, seed=seed, **proc)),
            (sampler.SequentialSampler(37, **proc),
             jax_sampler.SequentialSampler(37, **proc)),
            (sampler.WeightedSampler(_labels(), seed=seed, **proc),
             jax_sampler.WeightedSampler(_labels(), seed=seed, **proc))):
        np.testing.assert_array_equal(got.indices(epoch), want.indices(epoch))
        assert len(got) == len(want)


def _datasets(kind):
    """(port dataset, JAX dataset) holding the same arrays."""
    if kind == "twin":
        train = synthetic.make_synthetic_splits(
            "vggsound", 5, seed=1, n_train=37, n_val=4, n_test=4,
            shapes=SHAPES)[0]
        jtrain = jax_synthetic.make_synthetic_splits(
            "vggsound", 5, seed=1, n_train=37, n_val=4, n_test=4,
            shapes=SHAPES)[0]
        return train, jtrain
    rng = np.random.default_rng(4)
    arrays = [rng.normal(size=(37, 400)).astype(np.float32),
              rng.integers(0, 256, (37, 2, 6, 6, 3), dtype=np.uint8)]
    labels = rng.integers(0, 5, 37).astype(np.int32)
    return _WaveDataset(arrays, labels), _JaxWaveDataset(arrays, labels)


def _samplers(kind, dataset, jdataset, seed):
    if kind == "weighted":
        return (sampler.WeightedSampler(dataset.labels, seed=seed),
                jax_sampler.WeightedSampler(jdataset.labels, seed=seed))
    if kind == "random":
        return (sampler.RandomSampler(len(dataset), seed=seed),
                jax_sampler.RandomSampler(len(jdataset), seed=seed))
    return (sampler.SequentialSampler(len(dataset)),
            jax_sampler.SequentialSampler(len(jdataset)))


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for b, jb in zip(got, want):
        assert b.keys() == jb.keys()
        for k in jb:
            arr = jb[k]
            if arr.dtype == ml_dtypes.bfloat16:
                assert b[k].dtype == torch.bfloat16, k
                np.testing.assert_array_equal(
                    b[k].view(torch.int16).numpy().view(np.uint16),
                    arr.view(np.uint16), err_msg=k)
            else:
                assert b[k].numpy().dtype == arr.dtype, k
                np.testing.assert_array_equal(b[k].numpy(), arr, err_msg=k)


@pytest.mark.parametrize("data", ["twin", "waveform"])
@pytest.mark.parametrize("kind", ["weighted", "random", "sequential"])
@pytest.mark.parametrize("seed,epoch", PAIRS)
@pytest.mark.parametrize("skip", [0, 2])
@pytest.mark.parametrize("workers", [1, 3])
def test_host_batches_equal_jax(data, kind, seed, epoch, skip, workers):
    """Batch 8 over 37 rows: four full batches and a padded tail; with
    ``skip(2)`` the first two are dropped; ``workers=3`` splits each
    gather over a thread pool."""
    dataset, jdataset = _datasets(data)
    smp, jsmp = _samplers(kind, dataset, jdataset, seed)
    port = loader.Loader(dataset, 8, smp, workers=workers,
                         transfer_dtype=torch.bfloat16, device="cpu")
    jax_ = jax_loader.Loader(jdataset, 8, jsmp, workers=workers,
                             transfer_dtype=ml_dtypes.bfloat16)
    for ld in (port, jax_):
        ld.set_epoch(epoch)
        ld.skip(skip)
    got = list(port._host_batches())
    want = [{k: jax_._transfer_cast(k, v) for k, v in b.items()}
            for b in jax_._host_batches()]
    _assert_batches_equal(got, want)
    assert len(got) == len(port) - skip == 5 - skip
    # the skip is one-shot
    assert len(list(port._host_batches())) == 5


def test_host_cast_rounds_to_nearest_even_as_ml_dtypes():
    """Ties, subnormals, infinities and the largest finite values."""
    x = np.array([1.00390625, 1.01171875, -1.00390625, 3.0e38, -3.4e38,
                  1e-40, -1e-45, np.inf, -np.inf, 0.0, -0.0, 65504.0,
                  1.0 + 2 ** -8 + 2 ** -20], np.float32)
    x = np.concatenate([x, np.random.default_rng(0).normal(
        scale=100, size=4096).astype(np.float32)])
    got = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    np.testing.assert_array_equal(got.view(np.uint16),
                                  x.astype(ml_dtypes.bfloat16).view(np.uint16))


def test_loader_iterates_the_host_batches_on_the_cpu():
    dataset, _ = _datasets("twin")
    ld = loader.Loader(dataset, 8, sampler.RandomSampler(37, seed=2),
                       transfer_dtype=torch.bfloat16, device="cpu")
    ld.set_epoch(1)
    host = list(ld._host_batches())
    got = list(ld)
    for b, h in zip(got, host):
        assert all(torch.equal(b[k], h[k]) for k in h)
        assert b["x1"].dtype == torch.bfloat16
        assert b["x1"].device.type == "cpu"
    assert len(got) == 5
    assert got[-1]["valid"].tolist() == [1.0] * 5 + [0.0] * 3


def test_loader_without_transfer_dtype_keeps_f32():
    dataset, _ = _datasets("twin")
    ld = loader.Loader(dataset, 8, sampler.SequentialSampler(37),
                       device="cpu")
    assert next(iter(ld))["x1"].dtype == torch.float32


def test_loader_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dataset, _ = _datasets("twin")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loader.Loader(dataset, 8, sampler.SequentialSampler(37))


def _producers():
    return [t for t in threading.enumerate() if t.name == "loader-producer"]


def test_prefetch_producer_stops_when_abandoned():
    produced = []

    def host_batches():
        for i in range(1000):
            produced.append(i)
            yield i

    it = loader.prefetched_iter(host_batches(), lambda b: b, 2,
                                take=lambda b: -b)
    assert [next(it) for _ in range(3)] == [0, -1, -2]
    it.close()
    deadline = time.monotonic() + 10
    while _producers() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not _producers()
    assert len(produced) < 10


def test_prefetch_reraises_the_producers_error():
    def host_batches():
        yield 1
        raise ValueError("gather failed")

    it = loader.prefetched_iter(host_batches(), lambda b: b, 2)
    assert next(it) == 1
    with pytest.raises(ValueError, match="gather failed"):
        next(it)


def test_loader_warms_the_heap_as_the_jax_loader_does():
    """The Loader turns glibc's mmap path off once (``warm_heap``), as the
    JAX loader does at construction."""
    from multimodal_clinical_tpu_torch.utils import hostmem

    dataset, _ = _datasets("twin")
    loader.Loader(dataset, 8, sampler.SequentialSampler(37), device="cpu")
    assert hostmem._done
    assert hostmem.warm_heap()
