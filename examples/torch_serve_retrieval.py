"""End-to-end serving example on the PyTorch/CUDA port: build an index, then
serve batched queries through the two-stage pipeline (``serve_queries``)
with exact and Col-Bandit reranking, the rerank steps
``repro_torch.serve.RetrievalEngine`` warms.

  PYTHONPATH=src python examples/torch_serve_retrieval.py [--n-docs 512]
  PYTHONPATH=src python examples/torch_serve_retrieval.py --device cpu
"""
import argparse
import time

import numpy as np

from repro_torch.configs.base import BanditConfig
from repro_torch.data.synthetic import make_retrieval_dataset
from repro_torch.retrieval.index import build_index
from repro_torch.retrieval.pipeline import serve_queries


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the kernels) or 'cpu' (plain versions)")
    ap.add_argument("--n-docs", type=int, default=512)
    ap.add_argument("--n-queries", type=int, default=16)
    ap.add_argument("--alpha", type=float, default=0.3)
    args = ap.parse_args(argv)

    print(f"building index: {args.n_docs} docs on {args.device} ...")
    ds = make_retrieval_dataset(n_docs=args.n_docs, n_queries=args.n_queries,
                                seed=1)
    index = build_index(ds.doc_embs, ds.doc_mask, ds.doc_lens,
                        device=args.device)
    queries = np.asarray(ds.queries)                       # (B, T, M)

    t0 = time.time()
    dense = serve_queries(index, queries, k=5, flavor="dense",
                          device=args.device)
    bandit = serve_queries(index, queries, k=5, flavor="bandit",
                           bandit=BanditConfig(k=5, alpha_ef=args.alpha),
                           device=args.device)
    dt = time.time() - t0

    overlaps = []
    for qi in range(ds.n_queries):
        ov = len(set(dense.topk_ids[qi]) & set(bandit.topk_ids[qi])) / 5.0
        overlaps.append(ov)
        rel = set(np.nonzero(ds.qrels[qi])[0])
        rec = len(rel & set(int(d) for d in bandit.topk_ids[qi]
                            if d >= 0)) / max(len(rel), 1)
        print(f"  q{qi:02d}: overlap={ov:.2f} "
              f"coverage={100 * bandit.reveal_fraction[qi]:4.1f}% "
              f"recall@5={rec:.2f}")

    print(f"\nserved {ds.n_queries} queries in {dt:.1f}s: "
          f"mean coverage {100 * bandit.reveal_fraction.mean():.1f}%, "
          f"mean overlap@5 {np.mean(overlaps):.2f}, "
          f"frontier occupancy {bandit.stats[0]:.2f}")
    return float(np.mean(overlaps))


if __name__ == "__main__":
    main()
