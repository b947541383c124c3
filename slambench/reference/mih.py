"""A plain multi-index hash: the semantics of the port's native tables
(gf_orb_slam2_tpu_torch/csrc/mih.cpp, after GF-ORB-SLAM2's
include/Hashing.h:56-79), written again with Python lists and torch integer
operations, for holding the program's calls to its hash against.

It imports neither JAX nor anything of the port, and needs no speed.

- A 256-bit descriptor (eight 32-bit words, word 0 first, bit 0 of a word
  its least significant) is cut into `n_tables` substrings of `bits` bits:
  substring t is the bits [t * bits, (t + 1) * bits), read across a word
  boundary where it straddles one. It is the key of the point in table t,
  one of 2^bits buckets.
- A bucket holds at most `max_bucket` ids, oldest first. Inserting an id
  that is already the bucket's newest entry changes nothing (latest-entry
  dedup); otherwise, in a full bucket, the oldest entry is evicted first.
  `insert` returns how many entries it evicted.
- `erase(id)` removes every entry of the id from every bucket; `clear()`
  empties every bucket; `table_sizes()` counts the entries of each table.
- `query` walks the descriptors in order and, for each, the tables
  `table_sel` names in order (or tables 0 .. n_active - 1 when it is None;
  a name outside the tables is skipped), each bucket oldest entry first,
  and keeps the first appearance of each id in [0, seen_size), until
  `max_out` ids are out.

A second copy of this file is tests/plain_mih.py, for the CPU tests.
"""
from __future__ import annotations

import torch


def keys(desc, n_tables: int, bits: int) -> list:
    """The bucket keys [n][n_tables] of descriptors [n, 8] (32-bit words)."""
    d = torch.as_tensor(desc).to(torch.int64) & 0xFFFFFFFF
    d = d.reshape(-1, 8)
    mask = (1 << bits) - 1
    cols = []
    for t in range(n_tables):
        start = t * bits
        word, off = start >> 5, start & 31
        v = d[:, word] >> off
        if off + bits > 32 and word + 1 < 8:
            v = v | (d[:, word + 1] << (32 - off))
        cols.append(v & mask)
    if not cols:
        return [[] for _ in range(d.shape[0])]
    return torch.stack(cols, 1).tolist()


class PlainMIH:
    def __init__(self, n_tables: int, bits: int, max_bucket: int):
        self.n_tables, self.bits, self.max_bucket = n_tables, bits, max_bucket
        self.buckets = [[[] for _ in range(1 << bits)] for _ in range(n_tables)]

    def insert(self, desc, ids) -> int:
        ids = torch.as_tensor(ids).to(torch.int64).reshape(-1).tolist()
        evicted = 0
        for key, i in zip(keys(desc, self.n_tables, self.bits), ids):
            for t in range(self.n_tables):
                b = self.buckets[t][key[t]]
                if b and b[-1] == i:
                    continue
                if len(b) >= self.max_bucket:
                    b.pop(0)
                    evicted += 1
                b.append(i)
        return evicted

    def erase(self, point_id: int):
        for table in self.buckets:
            for b in table:
                b[:] = [i for i in b if i != point_id]

    def clear(self):
        for table in self.buckets:
            for b in table:
                b.clear()

    def table_sizes(self) -> list:
        return [sum(len(b) for b in table) for table in self.buckets]

    def query(self, desc, table_sel, n_active: int, max_out: int, seen_size: int) -> list:
        tables = list(range(n_active)) if table_sel is None else [
            int(t) for t in torch.as_tensor(table_sel).reshape(-1).tolist()[:n_active]]
        out, seen = [], set()
        if max_out <= 0:
            return out
        for key in keys(desc, self.n_tables, self.bits):
            for t in tables:
                if not 0 <= t < self.n_tables:
                    continue
                for i in self.buckets[t][key[t]]:
                    if 0 <= i < seen_size and i not in seen:
                        seen.add(i)
                        out.append(i)
                        if len(out) >= max_out:
                            return out
        return out
