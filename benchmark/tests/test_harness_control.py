"""The control, on the card: the reference in the program's place with TF32
on (the nearest precision below the configurations' float32) fails the
cell's limits, where the program's own runs pass them."""

import pytest
import torch


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["bluerov_1440.offline", "tum_fr1_640.vo", "bluerov_1440.stream"])
def test_control_fails_the_limits(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    import control

    from vobench import cells
    from vobench.compare import judge

    res = control.readings(cell, [2**31 + 21], [2**31 + 22, 2**31 + 23, 2**31 + 24], 3.0)
    limits = cells.limits(cell)
    assert judge(res["rows"]["program"][str(2**31 + 21)], limits)[0]
    for row in res["rows"]["control"].values():
        assert not judge(row, limits)[0]
