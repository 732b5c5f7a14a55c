"""CPU tests of the benchmark harness (run: ``python -m pytest -q
perfbench/tests`` from the checkout's root). Every cell runs here at a
tiny size on the CPU, where the engine takes its kernels' plain versions."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT), str(ROOT / "perfbench")):
    if p not in sys.path:
        sys.path.insert(0, p)

SEED = 2 ** 31 + 12345


def shrink(cell, pool: int = 64):
    """The cell at a size the CPU holds: 4,096 docs of at most 48 tokens,
    8 topics, ``pool`` queries; every width but the doc length as stated."""
    cell.config.update(n_docs=4096, n_topics=8,
                       doc_tokens=min(cell.config["doc_tokens"], 48),
                       min_doc_tokens=min(cell.config["min_doc_tokens"], 16))
    cell.traffic.update(query_pool=pool)
    return cell


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(min(4, old))
    yield
    torch.set_num_threads(old)
