"""Quickstart on the PyTorch/CUDA port: Col-Bandit reranking on a synthetic
corpus through the batched pipeline entry point
(``repro_torch.retrieval.pipeline.serve_queries``), the stage-1 + rerank
path the serving engine warms.

  PYTHONPATH=src python examples/torch_quickstart.py              # one card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.configs.base import BanditConfig
from repro_torch.data.synthetic import make_retrieval_dataset
from repro_torch.retrieval.index import build_index
from repro_torch.retrieval.pipeline import serve_queries


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the kernels) or 'cpu' (plain versions)")
    ap.add_argument("--n-docs", type=int, default=256)
    ap.add_argument("--n-queries", type=int, default=4)
    args = ap.parse_args(argv)

    ds = make_retrieval_dataset(n_docs=args.n_docs,
                                n_queries=args.n_queries, seed=0)
    index = build_index(ds.doc_embs, ds.doc_mask, ds.doc_lens,
                        device=args.device)
    queries = np.asarray(ds.queries)                       # (B, T, M)

    dense = serve_queries(index, queries, k=5, flavor="dense",
                          device=args.device)
    bandit = serve_queries(index, queries, k=5, flavor="bandit",
                           bandit=BanditConfig(k=5, alpha_ef=0.3),
                           device=args.device)

    overlap = np.mean([len(set(d) & set(b)) / 5.0
                       for d, b in zip(dense.topk_ids, bandit.topk_ids)])
    print(f"dense top-5 (q0) : {dense.topk_ids[0]}")
    print(f"bandit top-5 (q0): {bandit.topk_ids[0]}")
    print(f"mean overlap@5   : {overlap:.2f}")
    print(f"reveal fraction  : {100 * bandit.reveal_fraction.mean():.1f}% "
          f"of the MaxSim matrix (dense computes 100%)")
    print(f"frontier stats   : occupancy={bandit.stats[0]:.2f} "
          f"rounds={bandit.stats[1]:.0f} "
          f"lockstep_waste={bandit.stats[2]:.0f}")
    return dense, bandit


if __name__ == "__main__":
    main()
