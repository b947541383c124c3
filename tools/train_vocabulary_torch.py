#!/usr/bin/env python
"""Train a binary BoW vocabulary from images and save it as .npz, with the
PyTorch/CUDA port's ORB extractor (tools/train_vocabulary.py on the port:
the same arguments and output, plus --device).

Replaces the reference's offline DBoW2 vocabulary workflow + text→binary
converter (reference: tools/bin_vocabulary.cc). The vocabulary is k^levels
words, trained by host k-medians seeded with 0; it loads with
`gf_orb_slam2_tpu_torch.place.vocabulary.Vocabulary.load` (and the JAX
package's loader: the layout is shared).

Usage:
  python tools/train_vocabulary_torch.py --images /data/seq/*.png --out voc.npz \
      --k 10 --levels 4 [--device cuda]
"""
import argparse
import glob
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gf_orb_slam2_tpu_torch.config import ORBConfig  # noqa: E402
from gf_orb_slam2_tpu_torch.features.extractor import ORBExtractor  # noqa: E402
from gf_orb_slam2_tpu_torch.place.vocabulary import Vocabulary  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--images", nargs="+", required=True, help="paths or globs")
    ap.add_argument("--out", required=True)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--n-features", type=int, default=1000)
    ap.add_argument("--max-desc", type=int, default=200000)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the extractor (default: cuda; nothing falls back)")
    args = ap.parse_args(argv)

    import cv2

    paths = []
    for pattern in args.images:
        paths.extend(sorted(glob.glob(pattern)))
    if not paths:
        raise SystemExit("no images matched")
    extractors = {}
    descs = []
    for p in paths:
        img = cv2.imread(p, cv2.IMREAD_GRAYSCALE)
        if img is None:
            continue
        key = img.shape
        if key not in extractors:
            extractors[key] = ORBExtractor(ORBConfig(n_features=args.n_features), *img.shape,
                                           device=args.device)
        f = extractors[key](torch.from_numpy(img))
        d = f.desc[f.valid].cpu().numpy().view(np.uint32)
        descs.append(d)
        print(f"{p}: {len(d)} descriptors")
    data = np.concatenate(descs, 0)
    if len(data) > args.max_desc:
        data = data[np.random.default_rng(0).choice(len(data), args.max_desc, replace=False)]
    print(f"training on {len(data)} descriptors, k={args.k} levels={args.levels} "
          f"({args.k ** args.levels} words)")
    voc = Vocabulary.train(data, k=args.k, levels=args.levels)
    voc.save(args.out)
    print(f"saved {args.out}")


if __name__ == "__main__":
    main()
