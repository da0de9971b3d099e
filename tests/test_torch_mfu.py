"""The port's FLOP accounting and MFU report (utils/mfu.py) against the JAX
package's: the same FLOP count for a matmul, the datasheet peak lookup,
and the report's plumbing on the CPU (``mfu`` None)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from person_capture_tpu.utils import mfu as JM  # noqa: E402
from person_capture_tpu_torch.utils import mfu as TM  # noqa: E402


@pytest.mark.parametrize("m,k,n", [(64, 64, 64), (32, 48, 80)])
def test_program_cost_counts_matmul_flops_as_jax(m, k, n):
    a = np.ones((m, k), np.float32)
    b = np.ones((k, n), np.float32)
    want = JM.program_cost(jax.jit(lambda x, y: x @ y), jnp.asarray(a),
                           jnp.asarray(b))
    got = TM.program_cost(lambda x, y: x @ y, torch.from_numpy(a),
                          torch.from_numpy(b))
    assert got["flops"] == 2 * m * n * k == want["flops"]
    # the arguments and the result, each once
    assert got["bytes_accessed"] == 4 * (m * k + k * n + m * n)


def test_program_cost_counts_a_train_step_backward():
    """A backward pass counts too: a linear layer's forward and its weight
    gradient (the input needs none), twice the forward."""
    lin = torch.nn.Linear(32, 16, bias=False)
    x = torch.ones(8, 32)

    def step():
        lin.zero_grad()
        lin(x).sum().backward()

    assert TM.program_cost(step)["flops"] == 2 * 2 * 8 * 32 * 16


def test_chip_peak_lookup():
    assert TM.chip_peak_tflops("cpu") is None
    assert TM.chip_peak_tflops() is None or torch.cuda.is_available()
    assert TM.peak_for_name("NVIDIA H100 80GB HBM3") == 989.0
    assert TM.peak_for_name("NVIDIA H100 80GB HBM3", torch.float32) == 495.0
    assert TM.peak_for_name("NVIDIA H100 PCIe", torch.bfloat16) == 756.0
    assert TM.peak_for_name("NVIDIA H100 NVL", torch.float32) == 418.0
    assert TM.peak_for_name("NVIDIA A100-SXM4-80GB") is None


def test_mfu_report_on_the_cpu():
    x = torch.ones(128, 128)
    rep = TM.mfu_report(lambda t: (t @ t).sum(), (x,), n=4, reps=2,
                        device="cpu")
    assert rep["flops"] == 2 * 128 ** 3
    assert rep["ms_per_step"] > 0 and rep["achieved_tflops"] >= 0
    assert rep["mfu"] is None and rep["peak_tflops"] is None
    assert rep["peak_dtype"] == "bfloat16"
    assert TM.mfu_report(lambda t: t @ t, (x,), n=2, reps=1, device="cpu",
                         dtype=torch.float32)["peak_dtype"] == "tf32"
