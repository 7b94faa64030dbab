"""The port's roofline cost model (``horovod_tpu_torch/utils/costmodel.py``)
against the JAX package's (``horovod_tpu/utils/costmodel.py``): every
function on the tiny config and ``gpt2_small_tpu``, equal dicts, exact
arithmetic; the ChipSpec table holds the H100 rows and the reference's
``cpu`` stand-in and no TPU row; ``program_costs`` counts a step's FLOPs
with ``FlopCounterMode``.
"""

import pytest
import torch

from horovod_tpu.models import transformer as jtr
from horovod_tpu.utils import costmodel as jcm
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.utils import costmodel as tcm

CONFIGS = ("tiny", "gpt2_small_tpu")
LAYOUTS = [(64, 2, 1), (1024, 16, 1), (1024, 16, 4)]


def _cfgs(name, **kw):
    return (getattr(jtr.TransformerConfig, name)(**kw),
            getattr(ttr.TransformerConfig, name)(**kw))


@pytest.mark.parametrize("name", CONFIGS)
def test_lm_matmul_params_equal(name):
    jc, tc = _cfgs(name)
    assert tcm.lm_matmul_params(tc) == jcm.lm_matmul_params(jc)
    seq = 128
    assert (6 * tcm.lm_matmul_params(tc) + 12 * tc.num_layers * seq *
            tc.d_model == ttr.matmul_flops_per_token(tc, seq))


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("seq,batch,n", LAYOUTS)
def test_analytic_costs_and_activations_equal(name, seq, batch, n):
    jc, tc = _cfgs(name)
    assert tcm.analytic_lm_costs(tc, seq, batch, n_chips=n) == \
        jcm.analytic_lm_costs(jc, seq, batch, n_chips=n)
    assert tcm.analytic_lm_costs(tc, seq, batch, n_chips=n,
                                 wire_bytes_per_param=1.0) == \
        jcm.analytic_lm_costs(jc, seq, batch, n_chips=n,
                              wire_bytes_per_param=1.0)
    assert tcm.lm_activation_bytes(tc, seq, batch) == \
        jcm.lm_activation_bytes(jc, seq, batch)
    jc, tc = _cfgs(name, logits_fp32=False)
    assert tcm.lm_activation_bytes(tc, seq, batch) == \
        jcm.lm_activation_bytes(jc, seq, batch)


def _spec_pair(kind="cpu"):
    return tcm.chip_spec(kind), jcm.chip_spec(kind)


def test_cpu_row_equals_the_reference():
    t, j = _spec_pair()
    assert t.as_dict() == j.as_dict()
    assert tcm.peak_flops("cpu") is None and jcm.peak_flops("cpu") is None


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("seq,batch,n", LAYOUTS)
def test_roofline_and_mfu_decomposition_equal(name, seq, batch, n):
    jc, tc = _cfgs(name)
    tspec, jspec = _spec_pair()
    tcost = tcm.analytic_lm_costs(tc, seq, batch, n_chips=n)
    jcost = jcm.analytic_lm_costs(jc, seq, batch, n_chips=n)
    assert tcm.roofline(tcost, tspec) == jcm.roofline(jcost, jspec)
    dec = {"classes": [
        {"class": "flash_fwd", "ms_per_step": 3.0},
        {"class": "flash_dq", "ms_per_step": 1.5},
        {"class": "matmul", "ms_per_step": 20.0},
        {"class": "collective", "ms_per_step": 4.0},
        {"class": "fusion", "ms_per_step": 60.0},
        {"class": "copy", "ms_per_step": 2.5}]}
    assert tcm.measured_class_ms(dec) == jcm.measured_class_ms(dec)
    for wall in (0.0, 95.9, 1e5):
        assert tcm.mfu_decomposition(
            wall, tcost, tspec, tcm.measured_class_ms(dec)) == \
            jcm.mfu_decomposition(wall, jcost, jspec,
                                  jcm.measured_class_ms(dec))
    assert tcm.lm_attribution(tc, seq, batch, tspec, 95.9, dec,
                              n_chips=n) == \
        jcm.lm_attribution(jc, seq, batch, jspec, 95.9, dec, n_chips=n)


def test_the_table_holds_h100_rows_and_no_tpu_row():
    kinds = [s.kind for s in tcm.CHIP_SPECS]
    assert not any("TPU" in k for k in kinds)
    sxm = tcm.chip_spec("NVIDIA H100 80GB HBM3")
    assert (sxm.peak_flops, sxm.hbm_bytes_per_s, sxm.ici_bytes_per_s,
            sxm.hbm_capacity_bytes) == (989e12, 3.35e12, 900e9, 80e9)
    pcie = tcm.chip_spec("NVIDIA H100 PCIe")
    assert (pcie.peak_flops, pcie.hbm_bytes_per_s,
            pcie.hbm_capacity_bytes) == (756e12, 2.0e12, 80e9)
    assert tcm.chip_spec("NVIDIA H100 SXM5 80GB").peak_flops == 989e12
    assert tcm.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    # unknown kinds behave as in the reference: no spec, no peak
    assert tcm.chip_spec("NVIDIA A100-SXM4-80GB") is None
    assert tcm.chip_spec("TPU v5 lite") is None
    assert tcm.chip_spec(None) is None and jcm.chip_spec(None) is None
    assert tcm.peak_flops("NVIDIA A100-SXM4-80GB") is None
    assert tcm.chip_spec(torch.device("cpu")).kind == "cpu"


def test_longest_prefix_wins():
    specs = (tcm.ChipSpec("NVIDIA H100", 1.0, 1.0, 1.0),
             tcm.ChipSpec("NVIDIA H100 PCIe", 2.0, 1.0, 1.0))
    old = tcm.CHIP_SPECS
    tcm.CHIP_SPECS = specs
    try:
        assert tcm.chip_spec("NVIDIA H100 PCIe").peak_flops == 2.0
        assert tcm.chip_spec("nvidia h100 80GB HBM3").peak_flops == 1.0
    finally:
        tcm.CHIP_SPECS = old


def test_program_costs_counts_the_products():
    """FlopCounterMode counts the matmuls of a step: 2·m·n·k a product
    forward, twice that backward."""
    lin = torch.nn.Linear(32, 16, bias=False)
    x = torch.randn(8, 32, requires_grad=True)

    def step():
        lin(x).sum().backward()
    got = tcm.program_costs(step)
    assert got == {"flops": float(3 * 2 * 8 * 32 * 16), "bytes": None}
