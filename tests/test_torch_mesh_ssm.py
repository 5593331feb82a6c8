"""Port parity, training under the parallel plan: Jamba (the hybrid:
attention, Mamba with d_inner over "model", the MoE) and xLSTM (the mLSTM
over heads, the sLSTM on local rows) on a (data=2, model=2) mesh of 4
``gloo`` processes, against the reference's sharded step and the port's
unsharded step. The machinery, configurations and tolerances are
``tests/test_torch_mesh_moe.py``'s (:func:`run_jobs`).
"""
import pytest

from test_torch_mesh_moe import (check_against_reference,
                                 check_against_unsharded, job, run_jobs)

JOBS = [job("jamba", "jamba-v0.1-52b"), job("xlstm", "xlstm-125m")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_jobs(JOBS, tmp_path_factory.mktemp("mesh_ssm"))


@pytest.mark.parametrize("name", [j["name"] for j in JOBS])
def test_mesh_matches_reference(runs, name):
    check_against_reference(runs[name], name)


@pytest.mark.parametrize("name", [j["name"] for j in JOBS])
def test_mesh_matches_unsharded(runs, name):
    """Jamba's MoE layers route globally (the default dispatch), so its
    mesh step is the unsharded function too."""
    check_against_unsharded(runs[name], name)
