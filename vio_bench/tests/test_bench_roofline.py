"""The copied roofline counts against the program's own at parity shapes."""

import dataclasses

import pytest

from vio_bench import roofline, spec


@pytest.mark.parametrize("name", spec.cells())
def test_counts_equal_the_programs(name):
    from rebvio_tpu_torch.configs import PipelineConfig
    from rebvio_tpu_torch.ops import distance_field as DF
    from rebvio_tpu_torch.tools import roofline as TR

    p = spec.resolve(name).config["pipeline"]
    c = spec.build(PipelineConfig, p)
    mine = roofline.kernel_counts(dataclasses.asdict(c))
    assert mine["att_flood"] == TR.att_flood_counts(c)
    assert mine["att_field"] == TR.att_field_counts(c)
    assert mine["tube_match"] == TR.tube_match_counts(c.detector.keylines_max,
                                                       c.edge_map.tube_probes)
    # the minimize_vel solve: try_vel's pass counts, 1 + iterations passes
    K, passes = c.detector.keylines_max, 1 + c.core.iterations
    assert mine["minimize_vel"][1] == passes * TR.try_vel_counts(K)[1] + (passes - 1) * 150
    for sr in (3, 5, 20, 40, 41):
        assert roofline.flood_steps(sr) == DF.flood_steps(sr)
        assert roofline.flood_pad(sr) == DF.flood_pad(sr)
        for s in (1, 2, 3):
            assert roofline.field_geometry(sr, 480, 752, s) == DF.field_geometry(sr, 480, 752, s)
    assert (roofline.HBM_BYTES_PER_S, roofline.F32_FLOP_PER_S) == (TR.HBM_BYTES_PER_S,
                                                                   TR.F32_FLOP_PER_S)


def test_kernel_names_are_the_sources():
    """Every kernel the counts name is a __global__ of the program's csrc/."""
    src = "".join(p.read_text() for p in (spec.ROOT / "rebvio_tpu_torch" / "csrc").glob("*.cu"))
    for names in roofline.KERNEL_NAMES.values():
        for n in names:
            assert n in src, n
    assert roofline.kernel_of("void (anonymous namespace)::reg_ekf_alone(Launch)") == (
        "reg_ekf_alone", True)
    assert roofline.kernel_of("match_reg_ekf_gate(Launch)") == ("match_reg_ekf", False)
    assert roofline.kernel_of("void at::native::elementwise_kernel<4>") is None
