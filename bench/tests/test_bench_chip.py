"""On the card: the control (the reference in TF32, the precision
below the cells' float32) put in the program's place fails the check,
and the program passes it, at the paper's CNN on a cut population."""
import pytest
import torch

from bench_helpers import tiny_job
from fbench import result
from fbench.runners import fl_cnn


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cnn-fedcd-r16", "cnn-fedavg"])
def test_control_fails_and_program_passes(card, name, tmp_path):
    job = tiny_job(name, tmp_path, seed=2**31 + 77)
    job.device = "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ses = fl_cnn.Session(job, job.cell.config, job.cell.traffic)
    recs = ses.setup(str(tmp_path / "round_state"))
    sound = ses.check(recs)
    control = ses.check(recs, tf32=True)
    ses.close()
    assert result.verdict(sound, job.cell.limits)[0], sound
    ok, table = result.verdict(control, job.cell.limits)
    assert not ok, table
