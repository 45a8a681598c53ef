"""The port's XXH3, 2-bit helpers and exact-map probe against the JAX
package and the host implementation, bit for bit (tolerance zero)."""

import numpy as np
import pytest
import torch

from malva_tpu.index.device import pack2bit_u32_np
from malva_tpu.ops.xxh3 import xxh3_64
from malva_tpu_torch.ops import packed, seq
from malva_tpu_torch.ops import xxh3 as tx
from malva_tpu_torch.ops.bloom import bloom_set, from_u32, lanes, storage, to_u32

LENGTHS = [1, 2, 3, 4, 7, 8, 9, 16, 17, 35, 43, 64, 100, 128, 129, 200, 240]


def _u64(hi, lo):
    return (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(lo).astype(np.uint64)


@pytest.mark.parametrize("length", LENGTHS)
def test_xxh3_cols_matches_jax_and_host(length):
    import jax.numpy as jnp

    from malva_tpu.ops.xxh3_jax import xxh3_64_cols as jax_cols

    rng = np.random.default_rng(100 + length)
    data = rng.integers(0, 256, size=(96, length), dtype=np.uint8)
    hi, lo = tx.xxh3_64_cols([torch.from_numpy(data[:, j]) for j in range(length)])
    got = _u64(hi.numpy(), lo.numpy())
    np.testing.assert_array_equal(got, xxh3_64(data))
    jhi, jlo = jax_cols([jnp.asarray(data[:, j]) for j in range(length)])
    np.testing.assert_array_equal(got, _u64(jhi, jlo))


@pytest.mark.parametrize("size_bits", [1 << 33, 3 << 33, 4 << 33, 8 << 33,
                                       1 << 20, 1 << 31, 1 << 32, 32])
def test_mod_size_matches_jax(size_bits):
    import jax.numpy as jnp

    from malva_tpu.ops.xxh3_jax import xxh3_64_jax, xxh3_mod_size

    rng = np.random.default_rng(size_bits % 1000)
    data = rng.integers(0, 256, size=(256, 43), dtype=np.uint8)
    h = xxh3_64(data)
    hi = torch.from_numpy((h >> np.uint64(32)).astype(np.int64))
    lo = torch.from_numpy((h & np.uint64(0xFFFFFFFF)).astype(np.int64))
    w, b = tx.xxh3_mod_size(hi, lo, size_bits)
    jw, jb = xxh3_mod_size(xxh3_64_jax(jnp.asarray(data)), size_bits)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    idx = w.numpy().astype(np.uint64) * np.uint64(32) + b.numpy().astype(np.uint64)
    np.testing.assert_array_equal(idx, h % np.uint64(size_bits))


@pytest.mark.parametrize("size_bits", [9 << 33, 3 << 20, 16])
def test_mod_size_rejects_unsupported_sizes(size_bits):
    zero = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError):
        tx.xxh3_mod_size(zero, zero, size_bits)


def test_canonical_and_pack_match_host():
    """RCN canonicalization (IUPAC, lowercase, g->G quirk) and the 2-bit
    pack against malva_tpu.ops.seq and pack2bit_u32_np."""
    from malva_tpu.ops.seq import canonical

    rng = np.random.default_rng(7)
    alpha = np.frombuffer(b"ACGTNacgtnRYSWKM", dtype=np.uint8)
    rows = alpha[rng.integers(0, alpha.shape[0], size=(500, 43))]
    np.testing.assert_array_equal(seq.canonical_tensor(torch.from_numpy(rows)).numpy(), canonical(rows))
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, size=(500, 43))]
    got = seq.pack2bit(torch.from_numpy(acgt), 43).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, pack2bit_u32_np(acgt, 43))


@pytest.mark.parametrize("k,ref_k", [(35, 43), (31, 41), (32, 32), (17, 49)])
def test_canonical_center_matches_host(k, ref_k):
    """Packed centre extraction, 2-bit revcomp and lexicographic min ==
    the host canonical form of the ASCII centre, including palindromes."""
    from malva_tpu.ops.seq import canonical

    rng = np.random.default_rng(k * ref_k)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    ctx = acgt[rng.integers(0, 4, size=(400, ref_k))]
    off = (ref_k - k) // 2
    if k % 2 == 0:  # a few centres that are their own reverse complement
        from malva_tpu.ops.seq import revcomp

        half = ctx[:8, off : off + k // 2]
        ctx[:8, off : off + k] = np.concatenate([half, revcomp(half)], axis=1)
    words = [torch.from_numpy(c.astype(np.int64)) for c in pack2bit_u32_np(ctx, ref_k).T]
    can = packed.canonical_center(words, k, ref_k)
    want = pack2bit_u32_np(canonical(np.ascontiguousarray(ctx[:, off : off + k])), k)
    np.testing.assert_array_equal(np.stack([c.numpy() for c in can], 1).astype(np.uint32), want)
    ascii_cols = packed.decode_byte_cols(words, ref_k)
    np.testing.assert_array_equal(np.stack([c.numpy() for c in ascii_cols], 1), ctx)


def test_popcount_and_storage_roundtrip():
    rng = np.random.default_rng(1)
    w = rng.integers(0, 1 << 32, size=1000, dtype=np.uint64).astype(np.uint32)
    w[:3] = [0, 0xFFFFFFFF, 0x80000000]
    t = from_u32(w, "cpu")
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(to_u32(storage(lanes(t))), w)
    np.testing.assert_array_equal(packed.popcount32(lanes(t)).numpy(), np.bitwise_count(w))


def test_bloom_set_is_scatter_or():
    rng = np.random.default_rng(2)
    words = rng.integers(0, 1 << 32, size=64, dtype=np.uint64).astype(np.uint32)
    wi = rng.integers(0, 64, size=500)
    bi = rng.integers(0, 32, size=500)
    mask = rng.random(500) < 0.7
    want = words.copy()
    np.bitwise_or.at(want, wi[mask], (np.uint32(1) << bi[mask].astype(np.uint32)))
    t = from_u32(words, "cpu")
    bloom_set(t, torch.from_numpy(wi), torch.from_numpy(bi), torch.from_numpy(mask))
    np.testing.assert_array_equal(to_u32(t), want)


def test_bucket_probe_matches_jax():
    import jax.numpy as jnp

    from malva_tpu.index.kmap_table import BucketTable, probe_bucket_table
    from malva_tpu.ops.seq import canonical
    from malva_tpu_torch.index.kmap_table import probe_bucket_table as t_probe

    rng = np.random.default_rng(3)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    keys = canonical(acgt[rng.integers(0, 4, size=(300, 35))])
    table = BucketTable([r.tobytes() for r in keys], 35)
    queries = np.concatenate([keys[::3], canonical(acgt[rng.integers(0, 4, size=(100, 35))])])
    pk = pack2bit_u32_np(queries, 35)
    h = xxh3_64(queries)
    hi, lo = (h >> np.uint64(32)).astype(np.uint32), (h & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    jslot, jfound = probe_bucket_table(jnp.asarray(table.bucket_keys), table.n_buckets, 3,
                                       jnp.asarray(pk), jnp.asarray(hi), jnp.asarray(lo))
    slot, found = t_probe(from_u32(table.bucket_keys, "cpu"), table.n_buckets, 3,
                          [torch.from_numpy(c.astype(np.int64)) for c in pk.T],
                          torch.from_numpy(hi.astype(np.int64)),
                          torch.from_numpy(lo.astype(np.int64)))
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
    hit = found.numpy()
    np.testing.assert_array_equal(slot.numpy()[hit], np.asarray(jslot)[hit])
    assert found.numpy()[:100].all()
