"""Binary BoW vocabulary: hierarchical k-medians tree over ORB descriptors.

Replacement for DBoW2's TemplatedVocabulary (reference:
Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h — k-means++ tree, TF-IDF
weights, text/binary load with the binary loader added by the fork at
TemplatedVocabulary.h:1469), on the host in numpy, as the JAX package runs
it (`words_np`): a keyframe's transform is ~1k descriptors × levels × k
popcounts, microseconds on the host, where a device round trip would sit in
the keyframe event. `words` is the same descent on the vocabulary's device
(torch tensors in and out), for callers whose descriptors are there.

- The tree is complete: level l holds k^(l+1) centers, the children of node
  i are rows i·k..i·k+k-1 of the next level, and the word count is V = k^L.
- Training is host k-medians (bitwise-majority medoids) seeded by
  `np.random.default_rng(seed)`, so both packages train the same tree.
- Frames become sparse normalized tf-idf vectors (`bow_sparse`, the DBoW2
  BowVector) or dense [V] vectors (`bow_vector`).
- The vocabularies shipped with the repo (`gf_orb_slam2_tpu/assets/*.npz`)
  load with `Vocabulary.load`; DBoW2 text and binary files with
  `load_dbow2`.

Bits are counted through a byte table: numpy's `bitwise_count` needs numpy
2.0.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gf_orb_slam2_tpu_torch.ops.hamming_cuda import popcount_words

# set bits of every byte value
_POPC8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def _popcount_rows(x: np.ndarray) -> np.ndarray:
    return _POPC8[x.view(np.uint8)].sum(-1, dtype=np.int64)


def _hamming_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N,8] × [M,8] uint32 words → [N,M] Hamming distances."""
    return _popcount_rows(a[:, None, :] ^ b[None, :, :])


def _majority_center(desc: np.ndarray) -> np.ndarray:
    """Bitwise-majority medoid of [N,8] uint32 descriptors."""
    bits = np.unpackbits(desc.view(np.uint8), axis=-1)  # [N,256]
    maj = (bits.mean(0) >= 0.5).astype(np.uint8)
    return np.packbits(maj).view(np.uint32)


class Vocabulary:
    """k^L-word tree. centers: [L] arrays, level l of shape [k^(l+1), 8]
    uint32; idf: [V] word weights. `device` is where `words` runs (the
    tree's copy there is made at its first call)."""

    def __init__(self, centers, k: int, weights=None, device="cuda"):
        self.k = k
        self.levels = len(centers)
        self.centers = [np.asarray(c, np.uint32) for c in centers]
        self.V = self.centers[-1].shape[0]
        self.idf = (np.ones(self.V, np.float32) if weights is None
                    else np.asarray(weights, np.float32))
        self.to(device)

    def to(self, device) -> "Vocabulary":
        """Run `words` on `device` from now on; returns self."""
        self.device = torch.device(device)
        self._dev_centers = None
        return self

    # ------------------------------------------------------------- training
    @staticmethod
    def train(descriptors: np.ndarray, k: int = 10, levels: int = 3,
              iters: int = 8, seed: int = 0) -> "Vocabulary":
        """Hierarchical k-medians on [N,8] uint32 descriptors."""
        rng = np.random.default_rng(seed)
        centers_per_level = []
        clusters = [np.arange(len(descriptors))]  # index arrays at this level
        for lvl in range(levels):
            new_clusters = []
            level_centers = np.zeros((len(clusters) * k, 8), np.uint32)
            for ci, idx in enumerate(clusters):
                data = descriptors[idx] if len(idx) else descriptors[:1]
                if len(data) < k:
                    picks = rng.integers(0, len(data), k)  # degenerate: replicate
                else:
                    picks = rng.choice(len(data), k, replace=False)
                cent = data[picks].copy()
                assign = None
                for _ in range(iters):
                    assign = _hamming_np(data, cent).argmin(1)
                    for j in range(k):
                        m = assign == j
                        if m.any():
                            cent[j] = _majority_center(data[m])
                level_centers[ci * k: ci * k + k] = cent
                for j in range(k):
                    m = assign == j if assign is not None else np.zeros(len(data), bool)
                    new_clusters.append(idx[m] if len(idx) else np.array([], int))
            centers_per_level.append(level_centers)
            clusters = new_clusters
        voc = Vocabulary(centers_per_level, k)
        # idf from the training corpus
        counts = np.bincount(voc.words_np(descriptors), minlength=voc.V).astype(np.float32)
        voc.idf = np.log(len(descriptors) / np.maximum(counts, 1.0)).astype(np.float32)
        return voc

    # ------------------------------------------------------------ transform
    def words_np(self, desc: np.ndarray) -> np.ndarray:
        """[N,8] uint32 → word ids [N] int64: the tree descent, one [N,k]
        Hamming block per level, first minimum wins."""
        desc = np.ascontiguousarray(desc, np.uint32)
        n = desc.shape[0]
        if n == 0:
            return np.empty(0, np.int64)
        idx = np.zeros(n, np.int64)
        d8 = desc.view(np.uint8).reshape(n, 1, 32)
        for lvl in range(self.levels):
            child = idx[:, None] * self.k + np.arange(self.k)[None, :]
            cand = self.centers[lvl][child].view(np.uint8).reshape(n, self.k, 32)
            d = _POPC8[d8 ^ cand].sum(-1, dtype=np.int32)  # [n,k]
            idx = child[np.arange(n), d.argmin(1)]
        return idx

    def words(self, desc) -> torch.Tensor:
        """[N,8] descriptors (uint32 numpy, or a tensor of 32-bit words) →
        word ids [N] int64 on the vocabulary's device: the descent of
        `words_np` as tensor ops, one [N,k] Hamming block per level (bits
        counted by `popcount_words`: torch has no popcount), first minimum
        wins."""
        if self._dev_centers is None:
            self._dev_centers = [torch.from_numpy(c.view(np.int32)).to(self.device)
                                 for c in self.centers]
        if isinstance(desc, np.ndarray):
            desc = torch.from_numpy(np.ascontiguousarray(desc, np.uint32).view(np.int32))
        elif desc.dtype == torch.uint32:
            desc = desc.view(torch.int32)
        desc = desc.to(self.device)
        idx = torch.zeros(desc.shape[0], dtype=torch.int64, device=self.device)
        slots = torch.arange(self.k, device=self.device)
        for cents in self._dev_centers:
            child = idx[:, None] * self.k + slots  # [N,k]
            d = popcount_words(desc[:, None, :] ^ cents[child])
            idx = torch.gather(child, 1, torch.argmin(d, 1, keepdim=True))[:, 0]
        return idx

    def bow_vector(self, desc: np.ndarray, valid: Optional[np.ndarray] = None) -> np.ndarray:
        """Dense normalized tf-idf vector [V]."""
        d = desc if valid is None else desc[valid]
        if len(d) == 0:
            return np.zeros(self.V, np.float32)
        v = np.bincount(self.words_np(d), minlength=self.V).astype(np.float32) * self.idf
        return v / max(np.linalg.norm(v), 1e-9)

    def bow_sparse(self, desc: np.ndarray, valid: Optional[np.ndarray] = None):
        """Sparse normalized tf-idf: (word_ids [U] sorted int64, weights [U]
        float32) — the DBoW2 BowVector (reference: DBoW2/BowVector.h)."""
        d = desc if valid is None else desc[valid]
        if len(d) == 0:
            return np.empty(0, np.int64), np.empty(0, np.float32)
        ids, counts = np.unique(self.words_np(d), return_counts=True)
        wt = counts.astype(np.float32) * self.idf[ids]
        return ids.astype(np.int64), wt / max(np.linalg.norm(wt), 1e-9)

    # ------------------------------------------------------- DBoW2 interop
    @staticmethod
    def _from_dbow2_nodes(k: int, L: int, parents, descs, weights, is_leaf):
        """Embed a (possibly incomplete) DBoW2 tree into the complete k^L
        layout: real children fill the leading slots of their parent's block,
        the other slots copy the first child's descriptor (the first minimum
        wins, so they are unreachable); an early leaf continues as its own
        single child down to level L. Leaf weights land on the level-L slots."""
        n_nodes = len(parents) - 1  # parents[0] is a dummy; nodes are 1..n
        children: list = [[] for _ in range(n_nodes + 1)]
        for nid in range(1, n_nodes + 1):
            children[parents[nid]].append(nid)
        centers = [np.zeros((k ** (lvl + 1), 8), np.uint32) for lvl in range(L)]
        leaf_w = np.zeros(k ** L, np.float32)
        # (node id, or -id for an early leaf's continuation; complete index)
        frontier = [(0, 0)]
        for lvl in range(L):
            nxt = []
            for node, ci in frontier:
                kids = children[node] if node >= 0 else []
                base = ci * k
                if kids:
                    first_desc = descs[kids[0] - 1]
                    for j in range(k):
                        if j < len(kids):
                            c = kids[j]
                            centers[lvl][base + j] = descs[c - 1]
                            nxt.append((c, base + j))
                            if is_leaf[c] and lvl == L - 1:
                                leaf_w[base + j] = weights[c - 1]
                            elif is_leaf[c]:
                                nxt[-1] = (-c, base + j)  # early leaf continues
                        else:
                            centers[lvl][base + j] = first_desc
                else:
                    # early-leaf continuation: the whole block holds the leaf's
                    # descriptor, so slot 0 wins every tie
                    c = -node
                    d = descs[c - 1] if c >= 1 else np.zeros(8, np.uint32)
                    centers[lvl][base: base + k] = d
                    nxt.append((node, base))
                    if lvl == L - 1 and c >= 1:
                        leaf_w[base] = weights[c - 1]
            frontier = nxt
        return Vocabulary(centers, k, leaf_w)

    @staticmethod
    def load_dbow2_text(path) -> "Vocabulary":
        """DBoW2 text vocabulary (reference: TemplatedVocabulary::
        loadFromTextFile TemplatedVocabulary.h:1380): header 'k L scoring
        weighting', then one node per line 'parent is_leaf d0..d31 weight'."""
        with open(path, "r") as f:
            header = f.readline().split()
            k, L = int(header[0]), int(header[1])
            parents, descs, weights, is_leaf = [0], [], [], [False]
            for line in f:
                parts = line.split()
                if len(parts) < 35:
                    continue
                parents.append(int(parts[0]))
                is_leaf.append(int(parts[1]) > 0)
                descs.append(np.asarray([int(x) for x in parts[2:34]], np.uint8).view(np.uint32))
                weights.append(float(parts[34]))
        return Vocabulary._from_dbow2_nodes(
            k, L, parents, np.stack(descs), np.asarray(weights, np.float32), is_leaf)

    @staticmethod
    def load_dbow2_binary(path) -> "Vocabulary":
        """The fork's binary format (reference: TemplatedVocabulary::
        loadFromBinaryFile TemplatedVocabulary.h:1469): u32 nb_nodes,
        u32 size_node, i32 k, i32 L, i32 scoring, i32 weighting; per node
        i32 parent, 32 descriptor bytes, f32 weight, u8 is_leaf."""
        with open(path, "rb") as f:
            head = np.frombuffer(f.read(8), np.uint32)
            nb_nodes, size_node = int(head[0]), int(head[1])
            k, L, _scoring, _weighting = np.frombuffer(f.read(16), np.int32)
            raw = f.read(nb_nodes * size_node)
        rec = np.frombuffer(raw[: nb_nodes * size_node], np.uint8).reshape(nb_nodes, size_node)
        parents = [0] + [int(x) for x in rec[:, :4].copy().view(np.int32)[:, 0]]
        descs = np.ascontiguousarray(rec[:, 4:36]).view(np.uint32)
        weights = np.ascontiguousarray(rec[:, 36:40]).view(np.float32)[:, 0]
        is_leaf = [False] + [bool(x) for x in rec[:, 40]]
        return Vocabulary._from_dbow2_nodes(int(k), int(L), parents, descs,
                                            weights.astype(np.float32), is_leaf)

    @staticmethod
    def load_dbow2(path) -> "Vocabulary":
        """By suffix, as the reference picks its loader (System.cc:78-84):
        `.bin` binary, anything else text."""
        p = str(path)
        if p.endswith(".bin"):
            return Vocabulary.load_dbow2_binary(p)
        return Vocabulary.load_dbow2_text(p)

    def save_dbow2_text(self, path):
        """Write this (complete) tree in DBoW2 text format."""
        offsets = [1]  # node ids: root 0, level l's block after shallower ones
        for lvl in range(self.levels):
            offsets.append(offsets[-1] + self.centers[lvl].shape[0])
        with open(path, "w") as f:
            f.write(f"{self.k} {self.levels} 0 0\n")
            for lvl in range(self.levels):
                leaf = lvl == self.levels - 1
                for i, c in enumerate(self.centers[lvl]):
                    parent = 0 if lvl == 0 else offsets[lvl - 1] + i // self.k
                    w = float(self.idf[i]) if leaf else 0.0
                    f.write(f"{parent} {int(leaf)} "
                            + " ".join(str(int(x)) for x in c.view(np.uint8)) + f" {w}\n")

    # ---------------------------------------------------------------- io
    def save(self, path):
        np.savez_compressed(path, k=self.k, levels=self.levels, idf=self.idf,
                            **{f"centers_{i}": c for i, c in enumerate(self.centers)})

    @staticmethod
    def load(path, device="cuda") -> "Vocabulary":
        z = np.load(path)
        levels = int(z["levels"])
        return Vocabulary([z[f"centers_{i}"] for i in range(levels)], int(z["k"]), z["idf"],
                          device)
