"""Port parity, training under the parallel plan: Whisper (the
encoder-decoder; its self- and cross-attention on local rows and heads,
the residual streams pinned after every block) and Qwen2-VL (M-RoPE
positions [3, B, S] placed with the rows, embeddings in) on a (data=2,
model=2) mesh of 4 ``gloo`` processes, against the reference's sharded
step and the port's unsharded step. The machinery, configurations and
tolerances are ``tests/test_torch_mesh_moe.py``'s (:func:`run_jobs`).
"""
import pytest

from test_torch_mesh_moe import (check_against_reference,
                                 check_against_unsharded, job, run_jobs)

JOBS = [job("whisper", "whisper-large-v3"), job("qwen2_vl", "qwen2-vl-7b")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_jobs(JOBS, tmp_path_factory.mktemp("mesh_enc"))


@pytest.mark.parametrize("name", [j["name"] for j in JOBS])
def test_mesh_matches_reference(runs, name):
    check_against_reference(runs[name], name)


@pytest.mark.parametrize("name", [j["name"] for j in JOBS])
def test_mesh_matches_unsharded(runs, name):
    check_against_unsharded(runs[name], name)
