"""The port's ``configs`` against the reference's: every architecture's
published and smoke configuration, the shape cells and the derived counts
equal field for field."""
import dataclasses

import pytest

from repro import configs as ref_configs
from repro_torch import configs


def test_same_architectures():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS


@pytest.mark.parametrize("kind", ["config", "smoke"])
@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_config_fields_equal(arch, kind):
    get = {"config": (configs.get_config, ref_configs.get_config),
           "smoke": (configs.get_smoke_config,
                     ref_configs.get_smoke_config)}[kind]
    mine, ref = get[0](arch), get[1](arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.param_counts() == ref.param_counts()
    assert (mine.head_dim_, mine.pattern_period, mine.is_sub_quadratic) == (
        ref.head_dim_, ref.pattern_period, ref.is_sub_quadratic)
    for cells, ref_cells in ((configs.SHAPES, ref_configs.SHAPES),
                             (configs.SMOKE_SHAPES, ref_configs.SMOKE_SHAPES)):
        for name, cell in cells.items():
            assert configs.applicable(mine, cell) == ref_configs.applicable(
                ref, ref_cells[name])


def test_shape_cells_equal():
    for cells, ref_cells in ((configs.SHAPES, ref_configs.SHAPES),
                             (configs.SMOKE_SHAPES, ref_configs.SMOKE_SHAPES)):
        assert {k: dataclasses.asdict(v) for k, v in cells.items()} == {
            k: dataclasses.asdict(v) for k, v in ref_cells.items()}


def test_with_replaces_fields():
    cfg = configs.get_smoke_config("qwen3-0.6b").with_(
        compute_dtype="float32", n_layers=3)
    ref = ref_configs.get_smoke_config("qwen3-0.6b").with_(
        compute_dtype="float32", n_layers=3)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
