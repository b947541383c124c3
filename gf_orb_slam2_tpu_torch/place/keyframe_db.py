"""Keyframe database: BoW retrieval for loop detection + relocalization.

Replacement for KeyFrameDatabase (reference:
src/KeyFrameDatabase.cc — inverted index word→KFs, common-word counting,
score accumulation over covisibility groups; DetectLoopCandidates :84,
DetectRelocalizationCandidates :207).

Storage is SPARSE, like DBoW2's: per-KF sorted (word, weight) lists plus an
inverted index word → (kf, weight) postings. A query accumulates scores
with one `np.bincount` over the concatenated postings of its words — cost
scales with the posting mass touched, not with K×V, so 10⁵-10⁶-word
vocabularies work (a dense [K,V] matmul stops being viable past ~10⁴ words).
Host numpy only, like the vocabulary it reads.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from gf_orb_slam2_tpu_torch.place.vocabulary import Vocabulary
from gf_orb_slam2_tpu_torch.slammap.store import MapStore


class KeyFrameDatabase:
    def __init__(self, voc: Vocabulary, store: MapStore):
        self.voc = voc
        self.store = store
        K = store.cap.max_keyframes
        self.present = np.zeros(K, bool)
        self._kf_words: List = [None] * K    # sorted word ids [U]
        self._kf_weights: List = [None] * K  # matching weights [U]
        # inverted index: word -> (list of kf ids, list of weights)
        self._postings: Dict[int, Tuple[list, list]] = {}

    def add(self, kf: int):
        s = self.store
        if self.present[kf]:
            self.erase(kf)
        ids, wt = self.voc.bow_sparse(s.kf_desc[kf], s.kf_kp_valid[kf])
        self._kf_words[kf] = ids
        self._kf_weights[kf] = wt
        self.present[kf] = True
        for w, x in zip(ids.tolist(), wt.tolist()):
            post = self._postings.setdefault(w, ([], []))
            post[0].append(kf)
            post[1].append(x)

    def clear(self):
        """Reference: KeyFrameDatabase::clear (on system reset)."""
        self.present[:] = False
        self._kf_words = [None] * len(self._kf_words)
        self._kf_weights = [None] * len(self._kf_weights)
        self._postings.clear()

    def erase(self, kf: int):
        """Reference: KeyFrameDatabase::erase — drop the KF's postings."""
        if not self.present[kf]:
            return
        self.present[kf] = False
        for w in self._kf_words[kf].tolist():
            post = self._postings.get(w)
            if post is None:
                continue
            try:
                i = post[0].index(kf)
                post[0].pop(i)
                post[1].pop(i)
            except ValueError:
                pass
        self._kf_words[kf] = None
        self._kf_weights[kf] = None

    # ------------------------------------------------------------- scoring
    def _scores(self, q_words: np.ndarray, q_wt: np.ndarray) -> np.ndarray:
        """Accumulate cosine scores over the inverted index (one bincount)."""
        K = self.present.shape[0]
        kf_acc: List[list] = []
        wt_acc: List[np.ndarray] = []
        for w, qw in zip(q_words.tolist(), q_wt.tolist()):
            post = self._postings.get(w)
            if post is None or not post[0]:
                continue
            kf_acc.append(post[0])
            wt_acc.append(np.asarray(post[1], np.float32) * qw)
        if not kf_acc:
            return np.zeros(K, np.float32)
        kfs = np.concatenate([np.asarray(x, np.int64) for x in kf_acc])
        ws = np.concatenate(wt_acc)
        return np.bincount(kfs, weights=ws, minlength=K).astype(np.float32)

    def score_pair(self, a: int, b: int) -> float:
        """Sparse cosine between two stored KFs (both L2-normalized)."""
        if not (self.present[a] and self.present[b]):
            return 0.0
        wa, xa = self._kf_words[a], self._kf_weights[a]
        wb, xb = self._kf_words[b], self._kf_weights[b]
        common, ia, ib = np.intersect1d(wa, wb, return_indices=True)
        if common.size == 0:
            return 0.0
        return float(np.sum(xa[ia] * xb[ib]))

    def score_query(self, desc, valid) -> np.ndarray:
        q_w, q_x = self.voc.bow_sparse(desc, valid)
        return self._scores(q_w, q_x)

    # ------------------------------------------------------------ retrieval
    def detect_loop_candidates(self, kf: int, min_score: float) -> List[int]:
        """Reference: DetectLoopCandidates (KeyFrameDatabase.cc:84): exclude
        covisible KFs, keep scores ≥ min_score, accumulate scores over
        covisibility groups and return the best KF of each strong group."""
        s = self.store
        if self._kf_words[kf] is None:
            self.add(kf)
        connected = set(int(k) for k in s.covisible_kfs(kf))
        connected.add(kf)
        scores = self._scores(self._kf_words[kf], self._kf_weights[kf])
        cand_mask = self.present.copy()
        cand_mask[list(connected)] = False
        cand_mask &= scores >= min_score
        cands = np.nonzero(cand_mask)[0]
        if cands.size == 0:
            return []
        # group score: candidate + its top-10 covisible neighbors
        group_scores = []
        for c in cands:
            group = [int(c)] + [int(x) for x in s.covisible_kfs(int(c), 10)]
            g_sc = sum(scores[g] for g in group if self.present[g] and g not in connected)
            best_in_group = max(
                (g for g in group if self.present[g]), key=lambda g: scores[g]
            )
            group_scores.append((g_sc, int(best_in_group)))
        best_total = max(g for g, _ in group_scores)
        th = 0.75 * best_total
        out = []
        for g_sc, best in group_scores:
            if g_sc >= th and best not in out:
                out.append(best)
        return out

    def detect_reloc_candidates(self, desc, valid) -> List[int]:
        """Reference: DetectRelocalizationCandidates (KeyFrameDatabase.cc:207).
        Returns candidate KFs for a lost frame, best-of-group filtered."""
        if not self.present.any():
            return []
        scores = self.score_query(desc, valid)
        order = np.argsort(-scores * self.present)
        top = [int(k) for k in order[:10] if self.present[k] and scores[k] > 0]
        if not top:
            return []
        best = scores[top[0]]
        return [k for k in top if scores[k] >= 0.75 * best]

    def min_covis_score(self, kf: int) -> float:
        """Reference: LoopClosing.cc:136 — min BoW score between kf and its
        covisible neighbors sets the loop-candidate threshold."""
        s = self.store
        if self._kf_words[kf] is None:
            self.add(kf)
        neigh = s.covisible_kfs(kf)
        if neigh.size == 0:
            return 0.0
        scores = [self.score_pair(kf, int(n)) for n in neigh
                  if self.present[int(n)]]
        return min(scores) if scores else 0.0
