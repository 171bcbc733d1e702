"""mq3d_tpu_torch's batch-of-sessions axis (parallel/multihost.py), its CLI
(scripts/batch_run_full_pipeline.py), utils/parallel_utils.py,
parallel/dist.py's spawning and parallel/dryrun.py, on the CPU, against the
JAX package where it has a counterpart.

Multi-rank cases run as gloo ranks started by `spawn_ranks`, each with a
deadline.  The production-shape `dryrun_multichip` is marked slow, as the
JAX package's test_graft_dryrun is: it integrates into a 50 000-block pool
on the CPU (chip_smoke.py runs it on the card).
"""

import subprocess
import sys

import numpy as np
import pytest

from mq3d_tpu.parallel import multihost as jax_mh
from mq3d_tpu.utils import parallel_utils as jax_pu
from mq3d_tpu_torch.parallel import dryrun, multihost
from mq3d_tpu_torch.parallel.dist import spawn_ranks
from mq3d_tpu_torch.scripts import batch_run_full_pipeline as batch_cli
from mq3d_tpu_torch.utils import parallel_utils

DEADLINE_S = 120


@pytest.mark.parametrize("n_sessions", [0, 1, 7, 10])
@pytest.mark.parametrize("n_hosts", [1, 2, 3, 8])
def test_assign_sessions_matches_jax(n_sessions, n_hosts):
    for host_id in range(n_hosts):
        assert (multihost.assign_sessions(n_sessions, n_hosts, host_id)
                == jax_mh.assign_sessions(n_sessions, n_hosts, host_id))
    covered = sorted(i for h in range(n_hosts)
                     for i in multihost.assign_sessions(n_sessions, n_hosts, h))
    assert covered == list(range(n_sessions))


@pytest.mark.parametrize("host_id,n_hosts", [(1, None), (3, 2), (-1, 2)])
def test_resolve_host_topology_rejects_a_bad_host_id(host_id, n_hosts):
    with pytest.raises(ValueError):
        multihost.resolve_host_topology(host_id, n_hosts)
    with pytest.raises(ValueError):
        jax_mh.resolve_host_topology(host_id, n_hosts)


def test_resolve_host_topology_without_a_group():
    assert multihost.resolve_host_topology() == (0, 1)
    assert multihost.resolve_host_topology(1, 3) == (1, 3)


def _dirs(tmp_path, n):
    dirs = [tmp_path / f"2025010{i}_120000" for i in range(n)]
    for d in dirs:
        d.mkdir()
    return dirs


@pytest.mark.parametrize("impl", [multihost, jax_mh], ids=["port", "jax"])
def test_single_host_batch_rollup(tmp_path, impl):
    """A stub runner: a raising session is isolated and counted failed."""
    def runner(session):
        if session.name.endswith("2_120000"):
            raise RuntimeError("boom")
        return not session.name.endswith("1_120000")

    status = impl.batch_sessions_multihost(_dirs(tmp_path, 4), runner=runner,
                                           host_id=0, n_hosts=1)
    np.testing.assert_array_equal(status, [1, 0, 0, 1])


def test_sharded_host_sees_only_its_shard(tmp_path, capsys):
    ran = []
    status = multihost.batch_sessions_multihost(
        _dirs(tmp_path, 5), runner=lambda s: ran.append(s.name) or True,
        host_id=1, n_hosts=2)
    assert [n[7] for n in ran] == ["1", "3"]  # strided shard
    # No process group in this process: remote sessions stay unknown.
    np.testing.assert_array_equal(status, [-1, 1, -1, 1, -1])
    assert "roll-up unavailable (no process group is live)" in capsys.readouterr().out


def test_rollup_merges_two_hosts():
    """Two gloo ranks, each filling its strided share (session 1 failing),
    both end with the merged vector."""
    out = spawn_ranks("mq3d_tpu_torch.parallel.multihost:_rank_batch_dryrun", 2, "gloo",
                      "cpu", 5, timeout_s=DEADLINE_S)
    for merged in out:
        np.testing.assert_array_equal(merged, [1, 0, 1, 1, 1])


@pytest.mark.parametrize("n_hosts", [2, 4])
def test_dryrun_batch_multihost_matches_jax(n_hosts):
    got = multihost.dryrun_batch_multihost(n_hosts, n_sessions=11, timeout_s=DEADLINE_S)
    np.testing.assert_array_equal(got, jax_mh.dryrun_batch_multihost(n_hosts, n_sessions=11))


def test_cli_dry_run_lists_the_sessions(tmp_path, capsys):
    dirs = _dirs(tmp_path, 3)
    (tmp_path / "not_a_session").mkdir()
    assert batch_cli.main(["--base-dirs", str(tmp_path), str(tmp_path / "missing"),
                           "--dry-run"]) == 0
    out = capsys.readouterr().out
    assert "Discovered 3 session(s)" in out and "Base dir does not exist" in out
    assert [line.split("would run: ")[1] for line in out.splitlines()
            if "would run: " in line] == [str(d) for d in dirs]


def test_cli_exits_1_when_a_session_fails(tmp_path):
    """Two empty sessions through the port's run_full_pipeline on the CPU:
    both fail, the CLI prints the roll-up and exits 1."""
    _dirs(tmp_path, 2)
    proc = subprocess.run(
        [sys.executable, "-m", "mq3d_tpu_torch.scripts.batch_run_full_pipeline",
         "--base-dirs", str(tmp_path), "--n-hosts", "1", "--host-id", "0", "--device", "cpu"],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1, proc.stderr[-2000:]
    assert "0/2 session(s) succeeded; status [0, 0]" in proc.stdout


def test_default_runner_runs_the_ports_cli(monkeypatch, tmp_path):
    calls = []

    def fake_run(cmd, **kw):
        calls.append((cmd, kw))
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(multihost.subprocess, "run", fake_run)
    assert multihost._default_runner(tmp_path / "s", tmp_path / "c.yml", reuse_cache=False,
                                     device="cpu")
    (cmd, kw), = calls
    assert cmd[:5] == [sys.executable, "-u", "-m", "mq3d_tpu_torch.scripts.run_full_pipeline",
                       "--session_dir"]
    assert cmd[cmd.index("--device") + 1] == "cpu" and "--no-cache" in cmd
    assert cmd[cmd.index("--config") + 1] == str(tmp_path / "c.yml")
    assert not any(str(c).endswith("scripts/run_full_pipeline.py") for c in cmd)
    assert str(multihost.Path(multihost.__file__).resolve().parents[2]) in kw["env"]["PYTHONPATH"]
    calls.clear()
    multihost._default_runner(tmp_path / "s", None, reuse_cache=True)
    cmd = calls[0][0]
    assert "--config" not in cmd and "--no-cache" not in cmd
    assert cmd[cmd.index("--device") + 1] == "cuda"


def _maybe_fail(x, y=0):
    if x == 3:
        raise ValueError("three")
    return x * 10 + y


@pytest.mark.parametrize("use_mp", [False, True])
@pytest.mark.parametrize("args", [[1, 2, 3, 4], [(1, 1), (3, 2), (5, 0)], [3]])
def test_parallel_map_matches_jax(use_mp, args, capsys):
    got = parallel_utils.parallel_map(_maybe_fail, args, max_workers=2,
                                      use_multiprocessing=use_mp, default_on_error=-1)
    want = jax_pu.parallel_map(_maybe_fail, args, max_workers=2,
                               use_multiprocessing=use_mp, default_on_error=-1)
    assert got == want
    assert -1 in got  # the failing item took default_on_error
    assert "[Error] _maybe_fail failed: three" in capsys.readouterr().out


def test_spawn_ranks_raises_with_the_failing_ranks_traceback():
    with pytest.raises(RuntimeError, match="TypeError"):
        spawn_ranks("mq3d_tpu_torch.parallel.dist:rank_slice", 2, "gloo", "cpu",
                    timeout_s=DEADLINE_S)


def test_spawn_ranks_kills_the_ranks_at_its_deadline():
    with pytest.raises(TimeoutError):
        spawn_ranks("mq3d_tpu_torch.parallel.dryrun:rank_run", 2, "gloo", "cpu",
                    [("rollup", {"n_sessions": 3})], timeout_s=0.2)


def test_entry_allocates_blocks():
    fn, args = dryrun.entry(device="cpu")
    assert fn(*args).n_active > 0


@pytest.mark.slow
def test_dryrun_multichip_cpu():
    out = dryrun.dryrun_multichip(2, device="cpu", backend="gloo", timeout_s=600)
    assert out[4]["n_active"] > 0
