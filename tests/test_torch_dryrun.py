"""``python -m person_capture_tpu_torch.dryrun`` (``dryrun.py``), the
port's counterpart of the JAX repo's ``__graft_entry__.py``, on virtual CPU
entries at TINY shapes: the mesh rule (``data:n/2,model:2`` for an even
``n`` of at least 4, else ``data:n``), every sharded program run once, and
the summary line."""

import re

import pytest

torch = pytest.importorskip("torch")

from person_capture_tpu_torch import dryrun  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_dryrun_multichip_8_on_the_cpu(capsys):
    line = dryrun.dryrun_multichip(8, device="cpu")
    assert capsys.readouterr().out.strip() == line
    m = re.fullmatch(
        r"dryrun_multichip ok: mesh=data:4,model:2 device=cpu shapes=TINY "
        r"best_fd=\[.*\] sharded_vs_1dev_max_delta=(\S+) "
        r"spatial_detect=ok train_loss=(\S+)", line)
    assert m, line
    assert float(m.group(1)) < 1e-3
    assert float(m.group(2)) > 0


def test_dryrun_cli_odd_count_is_data_parallel(capsys):
    assert dryrun.main(["3", "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip()
    assert line.startswith("dryrun_multichip ok: mesh=data:3 device=cpu")
    assert "spatial_detect=dp-only" in line
