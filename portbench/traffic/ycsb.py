"""YCSB's key and request generators, in NumPy (after
github.com/brianfrankcooper/YCSB, ``core/.../Utils.java``,
``ZipfianGenerator.java``, ``ScrambledZipfianGenerator.java`` and
``CoreWorkload.java``).

- ``fnvhash64``: YCSB's 64-bit FNV-1 over the eight bytes of a record
  number, low byte first, then ``Math.abs``.  With ``insertorder=hashed``
  CoreWorkload names record ``n`` by ``fnvhash64(n)``.
- ``record_keys``: the index's keys, ``fnvhash64`` folded into the int32
  key domain [1, 2**31 - 2]; a record whose folded key repeats an earlier
  record's is dropped, so record ``i`` is the ``i``-th distinct key.
- ``scrambled_zipfian``: YCSB's scrambled zipfian.  Ranks are drawn from
  a zipfian over 10**10 items with YCSB's precomputed zeta (constant 0.99),
  then hashed onto the item range, so the hot items lie scattered over the
  records and not at their start.
"""

from __future__ import annotations

import numpy as np

FNV_OFFSET_BASIS_64 = np.uint64(0xCBF29CE484222325)
FNV_PRIME_64 = np.uint64(1099511628211)
KEY_SPAN = 2**31 - 2          # int32 keys 1 .. 2**31 - 2 (0 and 2**31 - 1 reserved)
ZIPF_ITEMS = 10_000_000_000   # ScrambledZipfianGenerator.ITEM_COUNT
ZIPF_ZETAN = 26.46902820178302   # its ZETAN, zeta(ITEM_COUNT, 0.99)
ZIPF_THETA = 0.99             # its USED_ZIPFIAN_CONSTANT


def fnvhash64(vals) -> np.ndarray:
    """YCSB's ``Utils.fnvhash64`` over int64 values, as int64 >= 0 (Java's
    ``Math.abs``; its one negative result, for Long.MIN_VALUE, is kept)."""
    v = np.asarray(vals, dtype=np.int64).astype(np.uint64)
    h = np.full(v.shape, FNV_OFFSET_BASIS_64, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for _ in range(8):
            h ^= v & np.uint64(0xFF)
            v >>= np.uint64(8)
            h *= FNV_PRIME_64
    s = h.view(np.int64)
    return np.where(s < 0, -s, s)


def fold_key(h) -> np.ndarray:
    """A hash onto the int32 key domain [1, 2**31 - 2]."""
    return (np.asarray(h, np.int64) % KEY_SPAN) + 1


def record_keys(count: int) -> np.ndarray:
    """The first ``count`` distinct folded keys of records 0, 1, ... in
    insertion order (int64)."""
    out = np.zeros(0, np.int64)
    n = 0
    while out.size < count:
        want = count - out.size
        chunk = fold_key(fnvhash64(np.arange(n, n + want + want // 64 + 16)))
        n += chunk.size
        both = np.concatenate([out, chunk])
        _, first = np.unique(both, return_index=True)
        out = both[np.sort(first)]
    return out[:count]


def zipfian_ranks(rng, size: int, items: int = ZIPF_ITEMS,
                  theta: float = ZIPF_THETA,
                  zetan: float = ZIPF_ZETAN) -> np.ndarray:
    """``ZipfianGenerator.nextLong``: ranks in [0, items), rank 0 the most
    popular (Gray et al.'s method, as YCSB draws it)."""
    alpha = 1.0 / (1.0 - theta)
    zeta2 = 1.0 + 0.5**theta
    eta = (1.0 - (2.0 / items) ** (1.0 - theta)) / (1.0 - zeta2 / zetan)
    u = rng.random(size)
    uz = u * zetan
    tail = (items * np.power(eta * u - eta + 1.0, alpha)).astype(np.int64)
    return np.where(uz < 1.0, 0, np.where(uz < zeta2, 1, tail))


def scrambled_zipfian(rng, size: int, item_count: int,
                      theta: float = ZIPF_THETA) -> np.ndarray:
    """``ScrambledZipfianGenerator.nextValue`` over [0, item_count): a
    zipfian rank, hashed by ``fnvhash64``, modulo the item count."""
    if theta != ZIPF_THETA:
        raise ValueError("only YCSB's constant 0.99 has its precomputed zeta")
    return fnvhash64(zipfian_ranks(rng, size, theta=theta)) % item_count


def uniform_lengths(rng, size: int, lo: int, hi: int) -> np.ndarray:
    """Scan lengths uniform on [lo, hi] (``scanlengthdistribution=uniform``)."""
    return rng.integers(lo, hi + 1, size).astype(np.int32)
