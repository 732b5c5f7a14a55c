"""Calibrate alpha_ef on the PyTorch/CUDA port (paper Sec. 4.4): sweep the
relaxation parameter and print the quality-coverage frontier, so a
deployment can pick its operating point. The port's counterpart of
``examples/calibration_sweep.py``, through
``repro_torch.retrieval.pipeline.evaluate_dataset``.

  PYTHONPATH=src python examples/torch_calibration_sweep.py             # card
  PYTHONPATH=src python examples/torch_calibration_sweep.py --device cpu
"""
import argparse
from typing import Dict, List, Sequence

from repro_torch.configs.base import BanditConfig
from repro_torch.data.synthetic import (RetrievalDataset,
                                        make_retrieval_dataset)
from repro_torch.retrieval.pipeline import evaluate_dataset

ALPHAS = (0.05, 0.1, 0.2, 0.4, 0.8, 1.6)


def bench_dataset(n_docs: int = 384, n_queries: int = 12,
                  seed: int = 7) -> RetrievalDataset:
    """The paper-table benchmarks' synthetic corpus (``benchmarks/common.py``
    of the JAX package): 32 distractors a query."""
    return make_retrieval_dataset(n_docs=n_docs, n_queries=n_queries,
                                  distractors_per_query=32, seed=seed)


def frontier_bandit(ds: RetrievalDataset, *, k: int, method: str = "bandit",
                    alphas: Sequence[float] = ALPHAS,
                    use_ann_bounds: bool = True, epsilon: float = 0.1,
                    warmup_fraction: float = 0.0, bias_kappa: float = 0.25,
                    prereveal_ann: bool = False, **kw) -> List[Dict]:
    """One operating point per alpha_ef (paper Fig. 2 star markers); ``kw``
    goes to ``evaluate_dataset`` (``device``, ``index``, ``draws``)."""
    pts = []
    for alpha in alphas:
        cfg = BanditConfig(k=k, alpha_ef=alpha, epsilon=epsilon,
                           warmup_fraction=warmup_fraction,
                           bias_kappa=bias_kappa)
        out = evaluate_dataset(ds, method=method, k=k, bandit=cfg,
                               use_ann_bounds=use_ann_bounds,
                               prereveal_ann=prereveal_ann, **kw)
        out["alpha_ef"] = alpha
        pts.append(out)
    return pts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the kernels) or 'cpu' (plain versions)")
    ap.add_argument("--n-docs", type=int, default=256)
    ap.add_argument("--n-queries", type=int, default=8)
    ap.add_argument("--alphas", type=float, nargs="+", default=list(ALPHAS))
    args = ap.parse_args(argv)

    ds = bench_dataset(args.n_docs, args.n_queries)
    pts = frontier_bandit(ds, k=5, alphas=args.alphas, device=args.device)
    print("alpha_ef   coverage   overlap@5   flops_saving")
    for p in pts:
        print(f"{p['alpha_ef']:8.2f} {100*p['coverage']:9.1f}% "
              f"{p['overlap']:10.3f} {p['flops_saving']:11.1f}x")
    print("\npick the smallest alpha whose overlap meets your SLO; "
          "larger alpha = more conservative (more compute, higher fidelity).")
    return pts


if __name__ == "__main__":
    main()
