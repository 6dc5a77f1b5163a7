"""The `trajectory_branch` fixture of the port's streaming tests: the
segmented gradient and block Hessian on one branch of the footprint rule
(`optimalcontrolmps_torch.streaming.trajectories_fit`). A test file takes
it with `from torch_branches import trajectory_branch`."""

import pytest


@pytest.fixture(params=["kept", "checkpointed"])
def trajectory_branch(request, monkeypatch):
    """Every trajectory fits (kept), or none does (checkpointed). Returns
    the branch's name."""
    keep = request.param == "kept"
    monkeypatch.setattr("optimalcontrolmps_torch.streaming.trajectories_fit",
                        lambda state, n_times: keep)
    return request.param
