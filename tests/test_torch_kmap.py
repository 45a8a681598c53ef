"""The port's exact map (``malva_tpu_torch/index/kmap.py``) against
``malva_tpu.index.kmap.KMAP``, the reference.

The port answers pure-ACGT probes by one native search over its sorted
key view and every other probe by a lookup; the reference keeps a dict
lookup per probe.  Both must give the same counts, slots and map after
every kind of update, on key sets with pure, IUPAC and NUL-truncated
(shorter) keys and values at and above 2^31 (read back signed), with and
without the native library.
"""

import io

import numpy as np
import pytest

from malva_tpu.index.kmap import KMAP as RefKMAP
from malva_tpu_torch.index import kmap as tkmap
from malva_tpu_torch.index.kmap import KMAP
from malva_tpu_torch.ops.seq import canonical, pack_2bit, revcomp
from malva_tpu_torch.utils import native
from malva_tpu_torch.utils.timing import PhaseTimer

K = 11
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
MESSY = np.frombuffer(b"ACGTACGTACGTNRY", dtype=np.uint8)  # mostly pure


@pytest.fixture(params=["native", "python"])
def lib(request, monkeypatch):
    """Each test with the native library and on the Python path."""
    if request.param == "python":
        monkeypatch.setattr(native, "_LIB", None)
        monkeypatch.setattr(native, "_TRIED", True)
    else:
        assert native.load() is not None
    return request.param


def _keys(rng, n, mix):
    """``pure``: ACGT only; ``mixed``: some keys carry N (full length,
    impure) or R/Y (impure, or NUL-truncated where the reverse complement
    wins)."""
    return (ACGT if mix == "pure" else MESSY)[rng.integers(0, 4 if mix == "pure" else 15,
                                                           size=(n, K))]


def _pair(keys, rng):
    """The port's map and the reference's, with the same keys and the same
    values, half of them at or above 2^31."""
    ours, ref = KMAP(), RefKMAP()
    ours.add_keys(keys)
    ref.add_keys(keys)
    vals = rng.integers(0, 1 << 32, size=len(ref), dtype=np.uint64).tolist()
    ref.kmers.update(zip(list(ref.kmers), vals))
    ours.kmers.update(zip(list(ours.kmers), vals))
    assert list(ours.kmers.items()) == list(ref.kmers.items())
    return ours, ref


def _probes(rng, keys, n):
    """Half present (keys, some as their reverse complement), half drawn afresh
    (mostly absent), some with bytes outside ACGTN."""
    half = keys[rng.integers(0, len(keys), size=n // 2)]
    rc = rng.random(n // 2) < 0.5
    half[rc] = revcomp(half[rc])
    fresh = MESSY[rng.integers(0, 15, size=(n - n // 2, K))]
    return np.concatenate([half, fresh])


def _agree(ours, ref, probes):
    want = ref.get_counts(probes)
    np.testing.assert_array_equal(ours.get_counts(probes), want)
    found, slots = ours.get_slots(probes)
    rfound, rslots = ref.get_slots(probes)
    np.testing.assert_array_equal(found, rfound)
    np.testing.assert_array_equal(slots, rslots)
    got = np.zeros(len(probes), dtype=np.int64)
    got[found] = ours.snapshot_values()[slots[found]].view(np.int32)
    np.testing.assert_array_equal(got, want)
    assert (want < 0).any() or not found.any()  # values >= 2^31 read back signed


@pytest.mark.parametrize("mix", ["pure", "mixed"])
@pytest.mark.parametrize("n_probes", [100, 5000])
def test_counts_and_slots_match_the_reference(lib, mix, n_probes):
    rng = np.random.default_rng(n_probes + len(mix))
    keys = _keys(rng, 3000, mix)
    ours, ref = _pair(keys, rng)
    if mix == "mixed":
        lens = {len(k) for k in ours.kmers}
        assert K in lens and min(lens) < K  # NUL-truncated keys are there
        assert any(set(k) - set(b"ACGT") for k in ours.kmers if len(k) == K)
    _agree(ours, ref, _probes(rng, keys, n_probes))


@pytest.mark.parametrize("n_probes", [100, 5000])
def test_no_stale_values_after_an_update(lib, n_probes):
    """Updating the values of existing keys keeps the view (same count)
    and every answer reads the new values."""
    rng = np.random.default_rng(7)
    keys = _keys(rng, 3000, "mixed")
    ours, ref = _pair(keys, rng)
    probes = _probes(rng, keys, n_probes)
    _agree(ours, ref, probes)
    view = ours.key_view()
    fresh = rng.integers(0, 1 << 32, size=len(ref), dtype=np.uint64).tolist()
    ours.kmers.update(zip(list(ours.kmers), fresh))
    ref.kmers.update(zip(list(ref.kmers), fresh))
    assert ours.key_view() is view
    _agree(ours, ref, probes)


@pytest.mark.parametrize("how", ["add_keys", "dict_insert", "setter"])
def test_the_view_follows_new_keys(lib, how):
    """Keys added by ``add_keys``, by a direct insertion into the dict or
    with a swapped dict are found at once."""
    rng = np.random.default_rng(11)
    keys = _keys(rng, 2000, "mixed")
    ours, ref = _pair(keys, rng)
    new = _keys(rng, 500, "mixed")
    probes = np.concatenate([_probes(rng, keys, 2000), new])
    _agree(ours, ref, probes)
    if how == "add_keys":
        ours.add_keys(new)
        ref.add_keys(new)
    else:
        scratch = RefKMAP()
        scratch.add_keys(new)
        added = {key: v for key, v in scratch.kmers.items() if key not in ref.kmers}
        assert added
        for i, key in enumerate(added):
            ref.kmers[key] = (1 << 31) + i
        if how == "dict_insert":
            for i, key in enumerate(added):
                ours.kmers[key] = (1 << 31) + i
        else:
            ours.kmers = dict(ref.kmers)
    assert list(ours.kmers.items()) == list(ref.kmers.items())
    _agree(ours, ref, probes)


@pytest.mark.parametrize("mix", ["pure", "mixed"])
@pytest.mark.parametrize("n_probes", [100, 5000])
def test_increment_keys_is_exact(lib, mix, n_probes):
    rng = np.random.default_rng(3 * n_probes + len(mix))
    keys = _keys(rng, 3000, mix)
    ours, ref = _pair(keys, rng)
    probes = _probes(rng, keys, n_probes)
    counters = rng.integers(0, 1 << 32, size=n_probes, dtype=np.uint64).astype(np.uint32)
    ours.increment_keys(probes, counters)
    ref.increment_keys(probes, counters)
    assert list(ours.kmers.items()) == list(ref.kmers.items())
    _agree(ours, ref, probes)


@pytest.mark.parametrize("mix", ["pure", "mixed"])
def test_increment_packed_is_exact(lib, mix):
    """Packed canonical pure probes, repeats and wrap included; without
    the library it declines, and the ASCII path gives the same map."""
    rng = np.random.default_rng(5 + len(mix))
    keys = _keys(rng, 3000, mix)
    ours, ref = _pair(keys, rng)
    pure = ACGT[rng.integers(0, 4, size=(4000, K))]
    pure[:2000] = keys[rng.integers(0, len(keys), size=2000)]
    pure = pure[np.isin(pure, ACGT).all(axis=1)]
    packed = pack_2bit(canonical(pure))
    counters = rng.integers(0, 1 << 32, size=len(packed), dtype=np.uint64).astype(np.uint32)
    took = ours.increment_packed(packed, counters, K)
    assert took == (lib == "native")
    if not took:
        ours.increment_keys(pure, counters)
    if not ref.increment_packed(packed, counters, K):
        ref.increment_keys(pure, counters)
    assert list(ours.kmers.items()) == list(ref.kmers.items())
    _agree(ours, ref, _probes(rng, keys, 2000))


def test_the_route_follows_each_probe(lib):
    """Pure probes take the search and count as ``kmap.packed_queries``;
    impure ones the lookup (``kmap.dict_queries``); few hits in a large
    map read their values by key, and count there too."""
    rng = np.random.default_rng(13)
    keys = _keys(rng, 3000, "pure")
    ours, ref = _pair(keys, rng)
    impure = MESSY[rng.integers(0, 15, size=(300, K))]
    impure[:, 0] = ord("N")
    dense = keys[:1000]
    timer = PhaseTimer("malva-tpu-torch", out=io.StringIO())
    with timer.recording():
        _agree(ours, ref, np.concatenate([dense, impure]))
    searched = 2 * 1300 - 2 * 300 if lib == "native" else 0  # get_counts + get_slots
    assert timer.counters["kmap.packed_queries"] == searched
    assert timer.counters["kmap.dict_queries"] == 2 * 1300 - searched
    timer = PhaseTimer("malva-tpu-torch", out=io.StringIO())
    sparse = keys[:100]  # 100 hits * SNAPSHOT_HITS < 3000 keys
    assert 100 * tkmap.SNAPSHOT_HITS < len(ours)
    with timer.recording():
        np.testing.assert_array_equal(ours.get_counts(sparse), ref.get_counts(sparse))
    assert timer.counters["kmap.dict_queries"] == (100 if lib == "native" else 200)


def test_a_wider_probe_truncated_to_a_key(lib):
    """A probe wider than the keys whose canonical form is NUL-truncated to
    a pure key of their length (``TTT R revcomp(x)``: its reverse
    complement ``x \\0 AAA`` wins) finds that key, as do probes of the
    keys' width beside it."""
    rng = np.random.default_rng(23)
    keys = _keys(rng, 3000, "pure")
    ours, ref = _pair(keys, rng)
    x = np.array([k for k in ours.kmers if k[0] != ord("T")][:50], dtype="S")
    x = np.frombuffer(x.tobytes(), np.uint8).reshape(-1, K)
    wide = np.concatenate([np.full((len(x), 3), ord("T"), np.uint8),
                           np.full((len(x), 1), ord("R"), np.uint8), revcomp(x)], axis=1)
    assert ours.key_view().k == K
    want = ref.get_counts(wide)
    assert (want != 0).all()
    np.testing.assert_array_equal(ours.get_counts(wide), want)
    _agree(ours, ref, wide)
    _agree(ours, ref, _probes(rng, keys, 2000))


def test_one_view_holds_every_key(lib):
    """Each key is in exactly one of the view's parts, at its position in
    the dict's insertion order; the sorted rows ascend."""
    rng = np.random.default_rng(17)
    ours, _ = _pair(_keys(rng, 3000, "mixed"), rng)
    view = ours.key_view()
    keys = list(ours.kmers)
    seen = sorted(view.rest.values()) + ([] if view.rows is None else view.order.tolist())
    assert sorted(seen) == list(range(len(keys)))
    assert all(keys[i] == key for key, i in view.rest.items())
    if view.rows is None:
        assert lib == "python" and len(view.rest) == len(keys)
        return
    rows = view.rows.tolist()
    assert rows == sorted(rows) and len(set(map(tuple, rows))) == len(rows)
    assert all(keys[i] == bytes(r) for i, r in zip(view.order.tolist(),
               tkmap.unpack_2bit(view.rows, K)))


def test_the_state_round_trip_keeps_the_answers():
    rng = np.random.default_rng(19)
    ours, ref = _pair(_keys(rng, 2000, "mixed"), rng)
    back = KMAP.from_state(ours.state())
    probes = _probes(rng, _keys(rng, 2000, "mixed"), 3000)
    np.testing.assert_array_equal(back.get_counts(probes), ref.get_counts(probes))
