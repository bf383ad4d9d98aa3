"""The port's `io` (`paddle_tpu_torch/io/`) and `utils.cpp_extension`
against the JAX package's, on the CPU.

- Twins of the six `tests/test_io.py` cases and the seven
  `tests/test_shm_dataloader.py` cases: each runs in both packages and
  keeps its own assertions, and the port's batches equal the reference's
  exactly (same values, nothing is computed; same dtypes, but where the
  reference's JAX, with 64-bit types off, holds int64 data as int32: the
  port keeps int64, as `core/tensor.py`'s docstring says).  The workers'
  datasets live in `tests/torch_io_cases.py` (numpy only).
- Under one `np.random.seed`, the shuffled `BatchSampler`, `RandomSampler`
  (with and without replacement), `SubsetRandomSampler`,
  `WeightedRandomSampler`, `DistributedBatchSampler(shuffle=True)` and
  `random_split` give both packages the same indices, and a shuffled
  loader the same batches.
- A ring made by the port carries a reference producer's objects to the
  port's consumer (one byte layout); the port's `DistributedBatchSampler`
  without `num_replicas`/`rank` raises NotImplementedError (item 13.9).
"""
import ctypes
import multiprocessing as mp
import os

import numpy as np
import pytest

import paddle_tpu as R
import paddle_tpu_torch as P
from paddle_tpu.io import shm_ring as r_ring
from paddle_tpu.utils import cpp_extension as r_ext
from paddle_tpu_torch.io import shm_ring as p_ring
from paddle_tpu_torch.utils import cpp_extension as p_ext
from torch_io_cases import Bad, Records, SquareRows, Squares
from torch_op_test import on_cpu  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

BOTH = pytest.mark.parametrize("ns", [R, P], ids=["ref", "port"])


def arrays(batch):
    """A batch (Tensors, lists, dicts) -> the same structure of numpy."""
    if isinstance(batch, (list, tuple)):
        return [arrays(b) for b in batch]
    if isinstance(batch, dict):
        return {k: arrays(v) for k, v in batch.items()}
    return batch.numpy()


def same(got, want):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            same(g, w)
    elif isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            same(got[k], want[k])
    else:
        assert got.dtype == want.dtype or (got.dtype, want.dtype) == (
            np.int64, np.int32), (got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want)


def both(fn):
    """fn(ns) on the reference, then the port; the two results equal."""
    want, got = fn(R), fn(P)
    same(got, want)
    return got


# ---- tests/test_io.py ----

def test_basic_batching():
    def run(ns):
        batches = list(ns.io.DataLoader(Squares(), batch_size=4))
        assert len(batches) == 5
        x, y = batches[0]
        assert x.shape == [4]
        np.testing.assert_allclose(y.numpy(), [0, 1, 4, 9])
        return arrays(batches)
    both(run)


def test_shuffle_and_drop_last():
    def run(ns):
        np.random.seed(11)
        loader = ns.io.DataLoader(Squares(10), batch_size=3, shuffle=True,
                                  drop_last=True)
        batches = list(loader)
        assert len(batches) == 3
        seen = np.concatenate([b[0].numpy() for b in batches])
        assert len(set(seen.tolist())) == 9
        return arrays(batches)
    both(run)


def test_iterable_dataset():
    def run(ns):
        class Stream(ns.io.IterableDataset):
            def __iter__(self):
                for i in range(7):
                    yield np.float32(i)

        batches = list(ns.io.DataLoader(Stream(), batch_size=2))
        assert len(batches) == 4
        assert batches[-1].shape == [1]
        return arrays(batches)
    both(run)


def test_worker_prefetch_path():
    def run(ns):
        loader = ns.io.DataLoader(Squares(50), batch_size=5, num_workers=2)
        batches = list(loader)
        assert len(batches) == 10
        return arrays(batches)
    both(run)


def test_tensor_dataset():
    def run(ns):
        xs = ns.to_tensor(np.arange(12, dtype=np.float32).reshape(6, 2))
        ys = ns.to_tensor(np.arange(6, dtype=np.int32))
        ds = ns.io.TensorDataset([xs, ys])
        x0, y0 = ds[2]
        np.testing.assert_allclose(x0.numpy(), [4, 5])
        assert len(ds) == 6
        return [x0.numpy(), y0.numpy()]
    both(run)


def test_distributed_batch_sampler_shards():
    def run(ns):
        ds = Squares(20)
        s0 = ns.io.DistributedBatchSampler(ds, batch_size=2, num_replicas=2,
                                           rank=0)
        s1 = ns.io.DistributedBatchSampler(ds, batch_size=2, num_replicas=2,
                                           rank=1)
        idx0 = [i for b in s0 for i in b]
        idx1 = [i for b in s1 for i in b]
        assert len(idx0) == len(idx1) == 10
        assert set(idx0).isdisjoint(set(idx1))
        return [np.asarray(idx0), np.asarray(idx1)]
    both(run)


# ---- tests/test_shm_dataloader.py ----

RINGS = {R: r_ring, P: p_ring}


@BOTH
def test_ring_roundtrip_objects(ns):
    mod = RINGS[ns]
    assert mod.available(), mod._LIB_ERR
    ring = mod.ShmRing(f"tt_obj_{os.getpid()}_{ns.__name__}",
                       capacity=1 << 20)
    try:
        ring.put({"a": np.arange(5), "b": "x"})
        out = ring.get(timeout_ms=1000)
        np.testing.assert_array_equal(out["a"], np.arange(5))
        assert out["b"] == "x"
    finally:
        ring.free()


def _producer(modname, name):
    import importlib
    mod = importlib.import_module(modname)
    r = mod.ShmRing(name, create=False)
    for i in range(40):
        r.push_bytes(bytes([i]) * 30000)  # forces wraparound + blocking
    r.close_producer()


@BOTH
def test_ring_cross_process_order_and_wrap(ns):
    mod = RINGS[ns]
    ring = mod.ShmRing(f"tt_xp_{os.getpid()}_{ns.__name__}",
                       capacity=1 << 16)
    p = mp.get_context("fork").Process(target=_producer,
                                       args=(mod.__name__, ring.name))
    p.start()
    n = 0
    try:
        while True:
            b = ring.pop_bytes(timeout_ms=10000)
            assert b is not None and len(b) == 30000 and b[0] == n
            n += 1
    except EOFError:
        pass
    p.join()
    ring.free()
    assert n == 40


@BOTH
def test_ring_timeout_and_oversize(ns):
    ring = RINGS[ns].ShmRing(f"tt_to_{os.getpid()}_{ns.__name__}",
                             capacity=1 << 12)
    try:
        assert ring.pop_bytes(timeout_ms=50) is None  # timeout, not hang
        with pytest.raises(ValueError):
            ring.push_bytes(b"x" * (1 << 13))
    finally:
        ring.free()


def test_multiprocess_dataloader_matches_sync():
    def run(ns):
        assert RINGS[ns].available()
        ds = SquareRows()
        sync = ns.io.DataLoader(ds, batch_size=4, num_workers=0)
        mpdl = ns.io.DataLoader(ds, batch_size=4, num_workers=2,
                                use_shared_memory=True)
        got_s = [(x.numpy(), y.numpy()) for x, y in sync]
        got_m = [(x.numpy(), y.numpy()) for x, y in mpdl]
        assert len(got_s) == len(got_m) == 10
        for (xs, ys), (xm, ym) in zip(got_s, got_m):
            np.testing.assert_array_equal(xs, xm)
            np.testing.assert_array_equal(ys, ym)
        return [list(b) for b in got_m]
    both(run)


@BOTH
def test_multiprocess_dataloader_worker_error_surfaces(ns):
    dl = ns.io.DataLoader(Bad(), batch_size=2, num_workers=2,
                          use_shared_memory=True)
    with pytest.raises(RuntimeError, match="boom at 5"):
        for _ in dl:
            pass


def test_unpicklable_dataset_falls_back_to_threaded():
    def run(ns):
        class Local(ns.io.Dataset):  # local class: not picklable for spawn
            def __len__(self):
                return 6

            def __getitem__(self, i):
                return np.full((2,), i, np.float32)

        dl = ns.io.DataLoader(Local(), batch_size=2, num_workers=2,
                              use_shared_memory=True)
        assert not dl._picklable_for_workers()
        got = [x.numpy() for x in dl]
        assert len(got) == 3 and got[2][1][0] == 5.0
        return got
    both(run)


@BOTH
def test_cpp_extension_load_builds_and_calls(ns, tmp_path):
    load = (p_ext if ns is P else r_ext).load
    src = tmp_path / "ext_src.cc"
    src.write_text('extern "C" long triple(long x) { return 3 * x; }\n')
    lib = load("test_triple", [str(src)], build_directory=str(tmp_path))
    lib.triple.restype = ctypes.c_long
    lib.triple.argtypes = [ctypes.c_long]
    assert lib.triple(14) == 42


def test_the_ports_extensions_build_under_the_checkout():
    from pathlib import Path
    root = Path(p_ext.get_build_directory())
    if not os.environ.get("PADDLE_EXTENSION_DIR"):
        assert root == Path(P.__file__).resolve().parents[1] / "build" / \
            "paddle_tpu_torch" / "extensions"
    with pytest.raises(p_ext.ExtensionError, match="CppExtension"):
        p_ext.CUDAExtension(["x.cu"])


# ---- the samplers, the split and the collate function ----

def _sampled(ns):
    ds = Squares(23)
    out = []
    for build in (lambda: ns.io.RandomSampler(ds),
                  lambda: ns.io.RandomSampler(ds, replacement=True,
                                              num_samples=40),
                  lambda: ns.io.RandomSampler(ds, num_samples=7),
                  lambda: ns.io.SubsetRandomSampler([3, 1, 4, 15, 9, 2]),
                  lambda: ns.io.WeightedRandomSampler(
                      np.arange(1, 24, dtype=np.float64), 30),
                  lambda: ns.io.WeightedRandomSampler(
                      np.arange(1, 24, dtype=np.float64), 10,
                      replacement=False),
                  lambda: ns.io.BatchSampler(ds, shuffle=True, batch_size=4),
                  lambda: ns.io.SequenceSampler(ds)):
        np.random.seed(1234)
        s = build()
        got = list(s)
        out.append(np.asarray([i for b in got for i in b]) if got and
                   isinstance(got[0], list) else np.asarray(got))
        assert len(s) == len(got)
    for epoch in (0, 3):
        for rank in (0, 1, 2):
            s = ns.io.DistributedBatchSampler(ds, batch_size=3,
                                              num_replicas=3, rank=rank,
                                              shuffle=True, drop_last=rank == 1)
            s.set_epoch(epoch)
            batches = list(s)
            assert len(batches) == len(s)
            out.append(np.asarray([i for b in batches for i in b]))
    np.random.seed(99)
    parts = ns.io.random_split(ds, [10, 8, 5])
    out += [np.asarray(p.indices) for p in parts]
    np.random.seed(99)
    parts = ns.io.random_split(ds, [0.5, 0.5])
    out += [np.asarray(p.indices) for p in parts]
    assert [len(p) for p in parts] == [11, 12]
    np.random.seed(5)
    out += [b[0].numpy() for b in ns.io.DataLoader(ds, batch_size=5,
                                                   shuffle=True)]
    return out


def test_samplers_and_split_give_the_references_indices():
    both(_sampled)


def test_datasets_compose_concat_chain_subset():
    def run(ns):
        io = ns.io
        a, b = Squares(4), Squares(3)
        cat = io.ConcatDataset([a, b])
        comp = io.ComposeDataset([a, b])
        chain = io.ChainDataset([[1, 2], [3]])
        sub = io.Subset(a, [3, 0])
        assert len(cat) == 7 and len(comp) == 3 and len(sub) == 2
        return [np.asarray([cat[i][1] for i in range(7)] + [cat[-1][1]]),
                np.asarray(comp[2]), np.asarray([x for x in chain]),
                np.asarray([sub[0][1], sub[1][1]])]
    both(run)


def test_collate_nested_samples():
    def run(ns):
        batches = list(ns.io.DataLoader(Records(), batch_size=4))
        return [arrays(b) for b in batches]
    got = both(run)
    assert got[0]["ids"].dtype == np.int64 and \
        got[0]["pair"][1].dtype == np.int64 and got[0]["w"].dtype == \
        np.float32


def test_the_ports_loader_makes_tensors_on_the_expected_place():
    batches = list(P.io.DataLoader(SquareRows(), batch_size=8,
                                   num_workers=2, use_shared_memory=True))
    assert all(x.place == P.CPUPlace() and y.dtype == P.int64
               for x, y in batches)


def test_distributed_sampler_without_ranks_waits_for_eager_distributed():
    with pytest.raises(NotImplementedError, match="eager distributed/"):
        P.io.DistributedBatchSampler(Squares(4), batch_size=2)


def test_a_reference_producer_feeds_a_port_consumer():
    """One ring name, the port's ring (the consumer, its owner) and the
    reference's producer attached to it."""
    consumer = p_ring.ShmRing(f"tt_mix_{os.getpid()}", capacity=1 << 16)
    producer = r_ring.ShmRing(consumer.name, create=False)
    try:
        sent = [{"step": i, "x": np.arange(i * 1000, dtype=np.float32)}
                for i in range(12)]      # wraps the 64 KiB ring
        got = []
        for obj in sent:
            producer.put(obj)
            got.append(consumer.get(timeout_ms=1000))
        producer.close_producer()
        with pytest.raises(EOFError):
            consumer.pop_bytes(timeout_ms=1000)
        for g, w in zip(got, sent):
            assert g["step"] == w["step"]
            np.testing.assert_array_equal(g["x"], w["x"])
    finally:
        producer.free()
        consumer.free()


def test_io_namespace_is_the_references():
    def names(mod):
        return {n for n in dir(mod) if not n.startswith("_")
                and n != "annotations"}
    assert names(P.io) == names(R.io)
