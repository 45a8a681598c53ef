"""K1 (the call step) in the port against the JAX package, bit for bit.

The JAX side runs its Pallas kernel in interpret mode on the CPU; the
port runs its plain versions (CPU tensors).  Integer hashing and counters
are exact, so the tolerance is zero everywhere.
"""

import numpy as np
import pytest
import torch

from malva_tpu.index.device import DeviceIndex as JaxDeviceIndex
from malva_tpu.index.device import make_call_step_packed, pack2bit_u32_np
from malva_tpu.ops.pallas_kernels import make_callstep_hash_fn
from malva_tpu.ops.seq import canonical
from malva_tpu.pipeline import apply_sample_counts
from malva_tpu.utils.config import Config
from malva_tpu_torch.convert import device_index_from_arrays
from malva_tpu_torch.index.device import DeviceIndex, apply_sample_counts_device
from malva_tpu_torch.ops import kernels
from malva_tpu_torch.ops.bloom import from_u32, to_u32
from test_device import _tiny_index

K, REF_K = 35, 43
ALPHA = np.frombuffer(b"ACGT", dtype=np.uint8)


@pytest.mark.parametrize("with_ctx", [False, True])
def test_callstep_hash_matches_pallas(with_ctx):
    import jax.numpy as jnp

    rng = np.random.default_rng(11 + with_ctx)
    ctx = rng.integers(0, 1 << 32, size=(4096, 3), dtype=np.uint64).astype(np.uint32)
    fn = make_callstep_hash_fn(K, REF_K, interpret=True, with_ctx=with_ctx)
    want = [np.asarray(o).reshape(-1) for o in fn(*[jnp.asarray(ctx[:, j].reshape(-1, 128))
                                                     for j in range(3)])]
    got = kernels.callstep_hash(from_u32(ctx, "cpu"), K, REF_K, with_ctx)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.uint32), w)


def _contexts(rng, keys, n, all_interesting=False):
    alt_keys, ref_keys, ctx_keys = keys
    contexts = ALPHA[rng.integers(0, 4, size=(n, REF_K))]
    if all_interesting:
        half = n // 2
        contexts[:half, 4:39] = alt_keys[rng.integers(0, len(alt_keys), half)]
        contexts[half:, 4:39] = ref_keys[rng.integers(0, len(ref_keys), n - half)]
    else:
        contexts[:64, 4:39] = alt_keys[:64]
        contexts[64:128, 4:39] = ref_keys[:64]
        contexts[128:192] = ctx_keys[:64]
    return canonical(contexts)


def _jax_arrays(dev, minifilter):
    packed = np.asarray(dev.bf_packed).copy()
    if not minifilter:
        packed[:, 1] &= (1 << 28) - 1
    return {
        "bf_packed": packed, "bf_counts": np.asarray(dev.bf_counts),
        "ctx_words": np.asarray(dev.ctx_words), "kmap_keys": np.asarray(dev.kmap_keys),
        "kmap_vals": np.asarray(dev.kmap_vals), "size_bits": dev.size_bits, "k": dev.k,
        "ref_k": dev.ref_k, "n_buckets": dev.n_buckets, "minifilter": minifilter,
    }


@pytest.mark.parametrize("minifilter,all_interesting", [
    (True, False), (False, False), (True, True),
])
def test_call_step_matches_jax_step(minifilter, all_interesting):
    """The port's call step (plain, CPU) == make_call_step_packed with the
    Pallas front end in interpret mode, on the same index state."""
    import jax.numpy as jnp

    cfg = Config(k=K, ref_k=REF_K, bf_size=1 << 20)
    index, keys = _tiny_index(cfg)
    jdev = JaxDeviceIndex.from_host(index, cfg)
    arrays = _jax_arrays(jdev, minifilter)
    B = 512
    rng = np.random.default_rng(5 + 2 * minifilter + all_interesting)
    ctx = pack2bit_u32_np(_contexts(rng, keys, B, all_interesting), REF_K)
    counters = rng.integers(1, 255, size=B).astype(np.uint32)

    step = make_call_step_packed(K, REF_K, cfg.bf_size, jdev.n_buckets, B,
                                 minifilter=minifilter, use_pallas=True, interpret=True)
    state = jnp.concatenate([jnp.asarray(arrays["bf_counts"]), jnp.asarray(arrays["kmap_vals"])])
    want = np.asarray(step(jnp.asarray(arrays["bf_packed"]), state,
                           jnp.asarray(arrays["ctx_words"]), jnp.asarray(arrays["kmap_keys"]),
                           jnp.asarray(ctx), jnp.asarray(counters)))

    dev = device_index_from_arrays(arrays, "cpu")
    st = dev.state()
    dev.step(st, from_u32(ctx, "cpu"), from_u32(counters, "cpu"))
    got = to_u32(st)
    assert got.any()
    np.testing.assert_array_equal(got, want)


def test_from_host_matches_jax_layout():
    """DeviceIndex.from_host builds the same (W, 2) word+rank+mini-filter
    rows, context words and bucket table as the JAX package."""
    cfg = Config(k=K, ref_k=REF_K, bf_size=1 << 20)
    index, _ = _tiny_index(cfg, seed=4)
    jdev = JaxDeviceIndex.from_host(index, cfg)
    dev = DeviceIndex.from_host(index, cfg, "cpu")
    assert dev.minifilter and jdev.minifilter and dev.n_buckets == jdev.n_buckets
    for name in ("bf_packed", "bf_counts", "ctx_words", "kmap_keys", "kmap_vals"):
        np.testing.assert_array_equal(to_u32(getattr(dev, name)),
                                      np.asarray(getattr(jdev, name)), err_msg=name)


@pytest.mark.parametrize("packed_input", [False, True])
def test_apply_sample_counts_device_matches_host(packed_input):
    """State parity with the host apply (test_device.py:99 pattern):
    bf.counts and the exact map identical.  ASCII input includes rows with
    an N (host replay) and non-canonical rows (canonicalized first)."""
    from malva_tpu.ops.seq import pack_2bit

    cfg = Config(k=K, ref_k=REF_K, bf_size=1 << 20)
    rng = np.random.default_rng(3 + packed_input)
    index_h, keys = _tiny_index(cfg)
    index_d, _ = _tiny_index(cfg)
    contexts = _contexts(rng, keys, 2000)
    counters = rng.integers(1, 255, size=2000).astype(np.uint32)
    if packed_input:
        contexts = pack_2bit(contexts)
    else:
        contexts[600:700] = contexts[600:700, ::-1]  # not canonical
        contexts[700:720, 10] = ord("N")
        contexts[720:730, 4] = ord("N")

    apply_sample_counts(index_h, contexts, counters, cfg)
    stats = apply_sample_counts_device(index_d, contexts, counters, cfg, "cpu", batch=512)
    assert stats["steps"] == 4 and stats["kernel_ms"] is None
    np.testing.assert_array_equal(index_h.bf.counts, index_d.bf.counts)
    assert index_h.ref_bf.kmers == index_d.ref_bf.kmers
    assert index_d.bf.counts.any()


def test_reused_index_restarts_from_host_counters():
    """A reused DeviceIndex starts from the host counters, not from the
    previous sample's device state."""
    cfg = Config(k=K, ref_k=REF_K, bf_size=1 << 20)
    rng = np.random.default_rng(8)
    index_h, keys = _tiny_index(cfg)
    index_d, _ = _tiny_index(cfg)
    contexts = _contexts(rng, keys, 600)
    counters = rng.integers(1, 255, size=600).astype(np.uint32)
    dev = DeviceIndex.from_host(index_d, cfg, "cpu")
    for _ in range(2):
        apply_sample_counts_device(index_d, contexts, counters, cfg, "cpu", dev=dev)
    apply_sample_counts(index_h, contexts, counters, cfg)
    apply_sample_counts(index_h, contexts, counters, cfg)
    np.testing.assert_array_equal(index_h.bf.counts, index_d.bf.counts)
    assert index_h.ref_bf.kmers == index_d.ref_bf.kmers


def test_wrappers_take_no_other_device():
    """The plain version is taken for CPU tensors only: any other device
    raises instead of falling back."""
    meta = torch.zeros((128, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        kernels.callstep_hash(meta, K, REF_K, False)
    with pytest.raises(ValueError):
        kernels.ref_scan(meta[:, 0], meta[:, 0], torch.zeros(200, dtype=torch.uint8), 10,
                         k=K, ref_k=REF_K, size_bits=1 << 20)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A missing compiler fails the build loudly; nothing falls back."""
    from malva_tpu_torch.ops import _build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.library()
