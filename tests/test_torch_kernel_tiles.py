"""The host side of ``tools/torch_kernel_tiles.py``: the constants it
rewrites in each kernel's source to build the kernel on each tile (the
kernels themselves run only on a card, ``tests/test_torch_kernels_cuda.py``).
"""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import torch_kernel_tiles as tiles  # noqa: E402

KERNELS = sorted(tiles.KERNELS)


@pytest.mark.parametrize("kernel", KERNELS)
def test_the_source_names_the_tile_and_its_rule(kernel):
    th, kv, below = tiles.tree_rule(tiles.source(kernel))
    assert th % kv == 0 and th % 8 == 0 and below > 0


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("name,want", [("large", "0"),
                                       ("small", tiles.NEVER)])
def test_forced_rules(kernel, name, want):
    src = tiles.source(kernel)
    out = tiles.variant_sources(src)[name]
    assert tiles.RULE.search(out).group(1) == want
    assert tiles.TILE.search(out).groups() == tiles.TILE.search(src).groups()
    # nothing else of the source changes
    assert tiles.RULE.sub("", out) == tiles.RULE.sub("", src)


@pytest.mark.parametrize("kernel", KERNELS)
def test_a_tile_is_forced_large_at_its_height(kernel):
    out = tiles.variant_sources(tiles.source(kernel), [(32, 4)])["th32kv4"]
    assert tiles.tree_rule(out) == (32, 4, 0)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("tile", [(36, 4), (40, 3)])
def test_a_tile_the_kernel_cannot_take_is_refused(kernel, tile):
    with pytest.raises(SystemExit):
        tiles.variant_sources(tiles.source(kernel), [tile])
