"""``ds_tpu_metrics`` of the port (``python -m deepspeed_tpu_torch.
telemetry.cli``) against the JAX package's (``deepspeed_tpu/telemetry/
cli.py``, ``tests/unit/test_metrics_cli.py``).

Each case of JAX's CLI test runs through both CLIs, in this process, on
the same fixture logs (written through the port's session and exporter,
as a run writes them), with ``--peak-tflops`` passed explicitly where
MFU is computed (the defaults differ: the port's is the H100's 989
TFLOP/s). The two give equal JSON, equal text and equal exit codes;
then JAX's CLI reads a log the port's engine wrote.
"""

import contextlib
import io
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from deepspeed_tpu.telemetry import cli as jcli
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.models.gpt2 import GPT2LMHead, gpt2_tiny
from deepspeed_tpu_torch.telemetry import JsonlExporter, TelemetrySession
from deepspeed_tpu_torch.telemetry import cli as tcli
from deepspeed_tpu_torch.telemetry.watchdog import heartbeat_path
from tests.torch_threads import one_thread  # noqa: F401


def run(cli, *args):
    """(exit code, stdout, stderr) of one CLI call in this process."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = cli.main(list(args))
        except SystemExit as e:       # argparse usage errors
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


def both(*args):
    """The port's result, after holding it equal to JAX's."""
    got, want = run(tcli, *args), run(jcli, *args)
    assert got == want, args
    return got


def _session(path):
    return TelemetrySession(exporters=[JsonlExporter(str(path))])


def write_log(path, step_wall=0.1, steps=4, loss=2.0,
              flops_per_token=1000.0, tokens=512):
    session = _session(path)
    session.emit("run_start", flavor="dense", zero_stage=0, n_devices=8,
                 flops_per_token=flops_per_token)
    session.emit("compile", step=0, flavor="dense", param_bytes=10 ** 6,
                 static_peak_bytes=2 * 10 ** 6,
                 flops_per_token=flops_per_token, batch_tokens=tokens)
    for i in range(steps):
        session.step_event(
            step=i + 1, flavor="dense", wall_s=step_wall, loss=loss,
            tokens=tokens,
            phases={"dispatch": step_wall * 0.6,
                    "device_wait": step_wall * 0.3})
    session.emit("recompile", step=3, cache_size=2, expected=1,
                 message="recompiled")
    session.emit("health_guard", guard="loss_spike", action="warn",
                 step=2, reason="spiked")
    session.emit("checkpoint_save", step=4, tag="global_step4",
                 path="/tmp/x", duration_s=0.5, async_save=False)
    session.close()
    return str(path)


def write_supervisor_log(path):
    session = _session(path)
    session.emit("restart", cause="hang", failed_index=1, restarts=1,
                 world_size=2, downsize=False, backoff_s=0.5,
                 time_to_recover_s=2.0)
    session.emit("restart", cause="crash", failed_index=0, restarts=2,
                 world_size=2, downsize=True, backoff_s=1.0,
                 time_to_recover_s=4.0)
    session.emit("recovery_ladder", tier="hot_mirror", source="/tmp/hot",
                 step=7, duration_s=0.2)
    session.emit("supervisor_done", success=True, reason="completed",
                 restarts=2, downsizes=1, world_size=1)
    session.close()
    return str(path)


def write_serve_log(path, steps=10, wall_s=0.02, batch=2, max_batch=2):
    session = _session(path)
    for i in range(steps):
        session.emit("decode_step", step=i + 1, tokens=batch,
                     batch=batch, occupancy=batch / max_batch,
                     queue_depth=max(0, 3 - i), wall_s=wall_s)
    session.close()
    return str(path)


def write_fleet_log(path):
    session = _session(path)
    session.emit("fleet_dispatch", rid="a", replica=0, redispatched=0,
                 queue_depth=1)
    session.emit("replica_dead", replica=0, cause="crash", in_flight=1)
    session.emit("fleet_redispatch", rid="a", from_replica=0,
                 redispatched=1, backoff_s=0.05)
    session.emit("replica_recovered", replica=0,
                 time_to_recover_s=0.25, redispatched=1)
    for rid, latency, redispatched in (("a", 1.5, 1), ("b", 0.5, 0)):
        session.emit("request_complete", rid=rid, replica=1,
                     finish_reason="max_new_tokens", tokens=8,
                     latency_s=latency, redispatched=redispatched,
                     restarts=redispatched)
    session.emit("fleet_done", ok=True, requests=2, completions=2,
                 replicas=2, replicas_dead=1, dead_causes={"0": "crash"},
                 redispatched_total=1, aborted=0, shed=0, defers=0,
                 timeouts=0, latency_p99_s=1.5)
    session.close()
    return str(path)


def write_spec_serve_log(path, rounds=5, batch=2, accepted_per_row=1,
                         draft_len=3, draft_wall=0.004, verify_wall=0.006):
    session = _session(path)
    emitted = batch * (accepted_per_row + 1)
    for i in range(rounds):
        session.emit("decode_step", step=i + 1, tokens=emitted,
                     batch=batch, occupancy=1.0, queue_depth=0,
                     wall_s=draft_wall + verify_wall,
                     accepted_tokens=emitted,
                     accepted_drafts=batch * accepted_per_row,
                     draft_tokens=batch * draft_len, draft_len=draft_len,
                     draft_wall_s=draft_wall, verify_wall_s=verify_wall)
    session.close()
    return str(path)


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    d = tmp_path_factory.mktemp("metrics_logs")
    out = {"run": write_log(d / "run.jsonl"),
           "a": write_log(d / "a.jsonl", step_wall=0.1),
           "b": write_log(d / "b.jsonl", step_wall=0.15),
           "b2": write_log(d / "b2.jsonl", step_wall=0.2),
           "sup": write_supervisor_log(d / "sup.jsonl"),
           "serve": write_serve_log(d / "serve.jsonl"),
           "serve_slow": write_serve_log(d / "serve_b.jsonl", wall_s=0.03),
           "router": write_fleet_log(d / "router.jsonl"),
           "r0": write_serve_log(d / "replica0.jsonl", steps=3),
           "r1": write_serve_log(d / "replica1.jsonl", steps=9),
           "spec": write_spec_serve_log(d / "spec.jsonl"),
           "spec_fast": write_spec_serve_log(d / "spec_a.jsonl",
                                             accepted_per_row=2),
           "missing": str(d / "nope.jsonl"),
           "missing_host": str(d / "missing-host.jsonl")}
    session = _session(d / "empty.jsonl")
    session.emit("run_start", flavor="dense")
    session.close()
    out["empty"] = str(d / "empty.jsonl")
    corrupt = d / "corrupt.jsonl"
    corrupt.write_text(open(out["run"]).read() + "{truncated\n\n")
    out["corrupt"] = str(corrupt)
    resil = d / "resil.jsonl"
    write_log(resil)
    session = _session(resil)
    session.emit("recovery_ladder", tier="disk", source="/ckpt", step=4,
                 duration_s=1.0)
    session.emit("checkpoint_fallback", dir="/ckpt", resolved_tag="old",
                 skipped=1, checkpoints=[{"tag": "new"}])
    session.close()
    out["resil"] = str(resil)
    hb = d / "hb"
    hb.mkdir()
    (hb / "hb-p00000.json").write_text(json.dumps(
        {"t": 1.0, "process_index": 0, "step": 4}))
    (hb / "hb-p00001.json").write_text('{"t": 1.0, "proc')   # torn
    out["hb"] = str(hb)
    torn = d / "hb_torn"
    torn.mkdir()
    with open(heartbeat_path(torn, 1), "w") as f:
        json.dump({"t": 1.0, "process_index": 1, "step": 9,
                   "phase": "serve", "in_step": False}, f)
    with open(heartbeat_path(torn, 0), "w") as f:
        f.write('{"t": 123.4, "process_ind')
    out["hb_torn"] = str(torn)
    pm = d / "pm_hb"
    pm.mkdir()
    (pm / "hb-p00001.json").write_text(json.dumps(
        {"t": 2.0, "process_index": 1, "step": 9, "phase": "dispatch"}))
    out["pm_hb"] = str(pm)
    dump = d / "flight-p00000-crash-1.json"
    dump.write_text('{"schema": "ds-tpu-flight/1", "rea')   # torn write
    out["torn_dump"] = str(dump)
    return out


# ---------------------------------------------------------------------------
# each case of JAX's test_metrics_cli.py through both CLIs
# ---------------------------------------------------------------------------

def test_summary_text(logs):
    rc, out, _ = both("summary", logs["run"], "--peak-tflops", "989")
    assert rc == 0
    for text in ("dense flavor", "schema ds-tpu-telemetry/", "phase "
                 "breakdown", "dispatch", "device_wait", "1 recompile(s)",
                 "warn=1", "1 checkpoint save(s)"):
        assert text in out, text
    assert "mfu" in out.lower()


def test_summary_json_keys_and_mfu_math(logs):
    rc, out, _ = both("summary", logs["run"], "--json", "--peak-tflops",
                      "100")
    s = json.loads(out)
    assert rc == 0 and s["steps"] == 4 and s["tokens"] == 4 * 512
    tps = 512 / 0.1
    assert s["tokens_per_s"] == pytest.approx(tps, rel=1e-6)
    assert s["mfu"]["mfu"] == pytest.approx(tps * 1000.0 / 1e12 / 100.0,
                                            rel=1e-6)
    _, out2, _ = both("summary", logs["run"], "--json",
                      "--flops-per-token", "2000", "--peak-tflops", "100")
    assert json.loads(out2)["mfu"]["mfu"] == pytest.approx(
        2 * s["mfu"]["mfu"], rel=1e-6)
    assert s["events"]["recompile"] == 1
    assert s["events"]["health_guard"] == {"warn": 1}


def test_default_peak_is_the_h100s():
    """The one intended difference: the default peak is one H100 SXM's
    dense bf16 rate, and the help names the card."""
    assert tcli.DEFAULT_PEAK_TFLOPS == 989.0
    rc, out, _ = run(tcli, "summary", "--help")
    assert rc == 0 and "H100" in out and "989" in out


@pytest.mark.parametrize("args", [
    ("tail", "{run}", "-n", "2"),
    ("tail", "{run}", "--event", "step", "-n", "1", "--json"),
    ("diff", "{a}", "{b}", "--peak-tflops", "100"),
    ("diff", "{a}", "{b}", "--peak-tflops", "100", "--fail-over", "5"),
    ("diff", "{a}", "{b}", "--peak-tflops", "100", "--fail-over", "60"),
    ("diff", "{b}", "{a}", "--peak-tflops", "100", "--fail-over", "5"),
    ("diff", "{a}", "{b}", "--peak-tflops", "100", "--json"),
    ("summary", "{missing}"),
    (),
    ("summary", "{empty}", "--peak-tflops", "100"),
    ("summary", "{corrupt}", "--json", "--peak-tflops", "100"),
    ("summary", "{sup}", "--json", "--peak-tflops", "100"),
    ("summary", "{sup}", "--peak-tflops", "100"),
    ("summary", "{resil}", "--json", "--peak-tflops", "100"),
    ("aggregate", "{a}", "{b2}", "{missing_host}"),
    ("aggregate", "{a}", "{b2}", "--heartbeats", "{hb}", "--expect-hosts",
     "3"),
    ("postmortem", "{torn_dump}", "--heartbeats", "{pm_hb}",
     "--expect-hosts", "2"),
    ("summary", "{serve}", "--peak-tflops", "100"),
    ("summary", "{serve}", "--json", "--peak-tflops", "100"),
    ("diff", "{serve}", "{serve_slow}", "--peak-tflops", "100"),
    ("summary", "{router}", "--peak-tflops", "100"),
    ("summary", "{router}", "--json", "--peak-tflops", "100"),
    ("aggregate", "{router}", "{r0}", "{r1}"),
    ("aggregate", "{router}", "{r0}", "{r1}", "--json"),
    ("aggregate", "{r1}", "--heartbeats", "{hb_torn}", "--expect-hosts",
     "2"),
    ("summary", "{spec}", "--json", "--peak-tflops", "100"),
    ("summary", "{spec}", "--peak-tflops", "100"),
    ("diff", "{spec_fast}", "{spec}", "--peak-tflops", "100")],
    ids=lambda a: "-".join(x.strip("{}-") for x in a) or "no_subcommand")
def test_both_clis_give_equal_output(logs, args):
    """Equal stdout, stderr and exit code for every case of JAX's CLI
    test; the readings JAX's test pins hold on the port's output."""
    argv = [a.format(**logs) for a in args]
    rc, out, err = both(*argv)
    key = " ".join(args)
    if not args or "{missing}" in args:
        assert rc == 2                       # usage errors
    elif "{empty}" in args:
        assert rc == 1 and "no step events" in err
    elif "--fail-over" in args:
        assert rc == (1 if args[1:3] == ("{a}", "{b}") and "5" in args
                      else 0)
    elif "postmortem" in args:
        assert rc == 1 and "no usable flight dump" in err
        assert "heartbeat" in err
    else:
        assert rc == 0, (key, err)
    if "{corrupt}" in args:
        assert json.loads(out)["steps"] == 4
    if args[:2] == ("summary", "{sup}") and "--json" in args:
        s = json.loads(out)
        assert s["steps"] == 0
        assert s["events"]["restart"]["by_cause"] == {"hang": 1, "crash": 1}
    if "{resil}" in args:
        s = json.loads(out)
        assert s["events"]["recovery_ladder"]["by_tier"] == {"disk": 1}
    if "{missing_host}" in args or "{hb_torn}" in args:
        assert "NO HEARTBEAT" in out
    if args[:2] == ("summary", "{serve}") and "--json" in args:
        s = json.loads(out)
        assert s["mode"] == "serve" and s["mfu"] is None
        assert s["latency_s"]["p50"] == pytest.approx(0.02)
    if args[:2] == ("summary", "{router}") and "--json" in args:
        fl = json.loads(out)["fleet"]
        assert fl["replicas_dead"] == {"count": 1, "by_cause": {"crash": 1}}
    if args[:2] == ("summary", "{spec}") and "--json" in args:
        sp = json.loads(out)["speculative"]
        assert sp["mean_accepted"] == pytest.approx(2.0)
        assert sp["draft_efficiency"] == pytest.approx(1 / 3)
    if args[:1] == ("diff",) and "{spec}" in args:
        assert "speculative.mean_accepted" in out


def test_aggregate_ranks_the_straggler_and_no_shared_steps(tmp_path):
    """``test_forensics.py``'s aggregate cases: the slow host first in
    both CLIs' JSON and text; one log alone exits 1."""
    def host_log(path, pidx, host, walls):
        with open(path, "w") as f:
            f.write(json.dumps({
                "schema": "ds-tpu-telemetry/1", "event": "run_start",
                "t": 1000.0, "process_index": pidx, "process_count": 2,
                "hostname": host}) + "\n")
            for i, w in enumerate(walls):
                f.write(json.dumps({
                    "schema": "ds-tpu-telemetry/1", "event": "step",
                    "t": 1000.0 + i, "step": i, "wall_s": w,
                    "process_index": pidx, "hostname": host}) + "\n")
        return str(path)

    a = host_log(tmp_path / "a.jsonl", 0, "host-a", [0.10, 0.10, 0.10, 0.11])
    b = host_log(tmp_path / "b.jsonl", 1, "host-b", [0.10, 0.30, 0.25, 0.40])
    rc, out, _ = both("aggregate", a, b, "--json")
    ranking = json.loads(out)["straggler_ranking"]
    assert rc == 0 and ranking[0]["host"] == "host-b/p1"
    assert "=> straggler: host-b/p1" in both("aggregate", a, b)[1]
    rc, _, err = both("aggregate", a)
    assert rc == 1 and "nothing cross-host to compare" in err


def test_jax_cli_reads_the_port_engines_log(tmp_path):
    """A log the port's engine wrote (tiny GPT-2, telemetry on) reads the
    same in both CLIs: equal summaries, JSON and text, and equal tails."""
    log = tmp_path / "port.jsonl"
    engine, _, _, _ = initialize(
        model=GPT2LMHead(gpt2_tiny(dtype=torch.float32), device="cpu"),
        device="cpu", config={
            "train_batch_size": 8, "steps_per_print": 10 ** 9,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
            "telemetry": {"enabled": True, "jsonl_path": str(log),
                          "flops_per_token": 1e6}})
    batch = {"input_ids": np.random.default_rng(0).integers(
        0, 256, (8, 16)).astype(np.int32)}
    for _ in range(3):
        engine.train_batch(batch)
    engine.telemetry.close()
    rc, out, _ = both("summary", str(log), "--json", "--peak-tflops", "989")
    s = json.loads(out)
    assert rc == 0 and s["steps"] == 3 and s["flavor"] == "dense"
    assert set(s["phases"]) == {"dispatch", "device_wait"}
    assert s["mfu"]["flops_per_token"] == 1e6
    assert both("summary", str(log), "--peak-tflops", "989")[0] == 0
    assert both("tail", str(log), "-n", "5")[0] == 0


def test_the_cli_runs_as_a_module(tmp_path, logs):
    proc = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.telemetry.cli",
         "summary", logs["run"], "--json"], capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout)["mfu"]["peak_tflops"] == 989.0
