"""Document->shard routing: murmur3 hash partitioning.

Port copy of elasticsearch_tpu/parallel/routing.py, whole: `murmur3_hash`,
`murmur3_32` and `shard_for_id`, so one _id routes to the same shard in
both packages.

Replicates the reference's OperationRouting (server/src/main/java/org/
elasticsearch/cluster/routing/OperationRouting.java:245):

    shard = floorMod(murmur3(routing), num_shards)

using the same Murmur3 x86 32-bit variant as the reference's
Murmur3HashFunction (cluster/routing/Murmur3HashFunction.java) with seed 0
over the string's UTF-16-LE bytes — the reference writes two bytes per Java
char, `(byte) c` then `(byte)(c >>> 8)`, which is exactly UTF-16-LE.
(routingFactor = 1: there are no shrink/split APIs.)
"""

from __future__ import annotations


def _rotl32(x: int, r: int) -> int:
    x &= 0xFFFFFFFF
    return ((x << r) | (x >> (32 - r))) & 0xFFFFFFFF


def murmur3_hash(key: str, seed: int = 0) -> int:
    """Reference-compatible routing hash: murmur3_32 of UTF-16-LE bytes."""
    return murmur3_32(key.encode("utf-16-le"), seed)


def murmur3_32(data: bytes, seed: int = 0) -> int:
    """Murmur3 x86_32 over raw bytes; returns signed int32 like Java."""
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = seed & 0xFFFFFFFF
    n = len(data)
    rounded = n - (n % 4)
    for i in range(0, rounded, 4):
        k = int.from_bytes(data[i : i + 4], "little")
        k = (k * c1) & 0xFFFFFFFF
        k = _rotl32(k, 15)
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
        h = _rotl32(h, 13)
        h = (h * 5 + 0xE6546B64) & 0xFFFFFFFF
    k = 0
    tail = data[rounded:]
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * c1) & 0xFFFFFFFF
        k = _rotl32(k, 15)
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
    h ^= n
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    # Java int is signed.
    return h - 0x100000000 if h >= 0x80000000 else h


def shard_for_id(doc_id: str, num_shards: int) -> int:
    """floorMod(murmur3(id), num_shards), as in OperationRouting.java:245."""
    return murmur3_hash(doc_id) % num_shards
