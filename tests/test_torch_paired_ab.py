"""The port's paired A/B statistics (``tools/torch_paired_ab.py``) and its
bench matrix's cells (``tools/torch_bench_matrix.py``), held to
``tools/paired_ab.py`` and ``tools/bench_matrix.py``."""

import math
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools import bench_matrix, paired_ab  # noqa: E402
from tools import torch_bench_matrix, torch_paired_ab  # noqa: E402
from tools.torch_paired_ab import _parse_env, sign_test_p  # noqa: E402


def test_sign_test_exact_binomial():
    # all 6 pairs the same direction: p = 2 * (1/2)^6 = 0.03125
    assert math.isclose(sign_test_p([1.1] * 6), 2 / 64)
    # 3 up, 3 down: p = 1 (no evidence)
    assert sign_test_p([1.1, 1.1, 1.1, 0.9, 0.9, 0.9]) == 1.0
    # ties dropped
    assert math.isclose(sign_test_p([1.0, 1.0, 1.1, 1.1, 1.1, 1.1, 1.1]),
                        2 / 32)
    # empty / all-ties -> 1.0
    assert sign_test_p([]) == 1.0
    assert sign_test_p([1.0, 1.0]) == 1.0
    # 5/6 one way: p = 2 * (C(6,0)+C(6,1))/64 = 14/64
    assert math.isclose(sign_test_p([1.1, 1.1, 1.1, 1.1, 1.1, 0.9]),
                        14 / 64)
    # two pairs decide nothing: p >= 0.5 whatever their signs
    assert sign_test_p([1.2, 1.3]) == 0.5
    assert sign_test_p([1.2, 0.8]) == 1.0


def test_parse_env():
    assert _parse_env(["A=1,B=x", "C=3"]) == {"A": "1", "B": "x", "C": "3"}
    assert _parse_env(None) == {}
    assert _parse_env(["K=a=b"]) == {"K": "a=b"}


@pytest.mark.parametrize("seed", range(8))
def test_sign_test_equals_paired_ab(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 25))
    # ratios around 1 with ties: rounding to 2 decimals makes some exactly 1
    ratios = np.round(1 + rng.normal(0, 0.05, n), 2).tolist()
    assert sign_test_p(ratios) == paired_ab.sign_test_p(ratios)


@pytest.mark.parametrize("seed", range(4))
def test_parse_env_equals_paired_ab(seed):
    rng = np.random.default_rng(seed)
    items = []
    for _ in range(int(rng.integers(0, 4))):
        pairs = [f" K{rng.integers(0, 5)} = {'v=' * int(rng.integers(0, 2))}"
                 f"{rng.integers(0, 9)}" for _ in range(rng.integers(0, 3))]
        items.append(",".join(pairs + [""] * int(rng.integers(0, 2))))
    assert _parse_env(items) == paired_ab._parse_env(items)


def test_bench_matrix_cells_equal():
    assert torch_bench_matrix.CELLS == bench_matrix.CELLS


def test_bench_matrix_cell_filter():
    assert torch_bench_matrix._cells(None) == bench_matrix.CELLS
    assert torch_bench_matrix._cells("1080p/pan, 1080p/noise") == (
        ("1080p", "pan"), ("1080p", "noise"))
    with pytest.raises(SystemExit, match="unknown cells"):
        torch_bench_matrix._cells("8k/pan")


def test_paired_ab_needs_a_pair():
    with pytest.raises(SystemExit):
        torch_paired_ab.main(["--pairs", "0"])
