"""The port's continuous-batching server against the reference's.

``repro_torch.runtime.serve.Server(device="cpu")`` and
``repro.runtime.serve.Server`` on a one-device mesh serve the same
requests with the same weights, replaying the three scenarios of
``tests/test_runtime.py``'s ``TestServer``, then every family on fresh
slots.  Under float32 compute the generated tokens and the
``ServerStats`` are identical.  Where the port departs from a reference
fault (ROADMAP queue 3) it is held to the request served alone: a
recycled slot of a Mamba-2 model (the reference keeps the previous
request's SSM state) and whisper over a pool (the reference takes one
position for the batch).  Then the port's rules: its serving entry
points run on the card unless asked for the CPU, and the serve path runs
with ``jax`` and ``repro`` absent.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.launch.mesh import single_device_mesh
from repro.runtime.serve import Server as RefServer
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_reference
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model as port_model
from repro_torch.runtime.serve import Server

from _torch_parity import ref_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


def servers(arch, pool, max_seq=64):
    """The reference's and the port's server on the same float32-compute
    smoke model (the smoke depth: 2 layers, as test_runtime.py's; one
    period of 8 for jamba)."""
    cfg = ref_get_config(arch, smoke=True).replace(compute_dtype="float32")
    pcfg = get_config(arch, smoke=True).replace(compute_dtype="float32")
    params = ref_params(arch)
    model = port_model.Model(pcfg, device="cpu")
    model.load_state_dict(params_from_reference(
        jax.tree.map(np.asarray, params)))
    ref = RefServer(cfg, params, single_device_mesh(), pool=pool,
                    max_seq=max_seq)
    port = Server(pcfg, model, pool=pool, max_seq=max_seq, device="cpu")
    return ref, port


@pytest.mark.parametrize("arch", ["granite_3_2b", "llama3_2_3b"])
def test_serves_batched_requests_like_the_reference(arch):
    ref, port = servers(arch, pool=3)
    out = []
    for srv in (ref, port):
        reqs = [srv.submit([1, 2, 3], max_new_tokens=5) for _ in range(7)]
        stats = srv.run_until_drained()
        out.append(([r.out_tokens for r in reqs], dataclasses.asdict(stats)))
    assert out[1] == out[0]
    assert out[1][1]["completed"] == 7
    assert all(len(t) == 5 for t in out[1][0])


@pytest.mark.parametrize("arch", ["granite_3_2b", "llama3_2_3b"])
def test_continuous_batching_overlaps_like_the_reference(arch):
    """A request submitted mid-flight shares decode steps with the
    running pool; tokens and stats as the reference's."""
    ref, port = servers(arch, pool=2)
    out = []
    for srv in (ref, port):
        reqs = [srv.submit([1, 2, 3, 4], max_new_tokens=8),
                srv.submit([5, 6], max_new_tokens=8)]
        for _ in range(4):
            srv.step()
        reqs.append(srv.submit([7, 8, 9], max_new_tokens=8))
        stats = srv.run_until_drained()
        out.append(([r.out_tokens for r in reqs], dataclasses.asdict(stats)))
    assert out[1] == out[0]
    assert out[1][1]["completed"] == 3
    assert out[1][1]["steps"] < (4 + 8) + (2 + 8) + (3 + 8)


def test_server_matches_manual_decode():
    """Greedy continuation from the port's server == its own manual
    one-row decode loop (scalar positions) == the reference server's."""
    ref, port = servers("granite_3_2b", pool=2)
    prompt = [3, 1, 4, 1, 5]
    rr, pr = ref.submit(prompt, max_new_tokens=4), \
        port.submit(prompt, max_new_tokens=4)
    ref.run_until_drained()
    port.run_until_drained()
    caches = port_model.init_caches(port.cfg, 1, 64, device="cpu")
    out = []
    for t in range(len(prompt) + 3):
        cur = prompt[t] if t < len(prompt) else out[-1]
        logits, caches = port_model.decode_forward(
            port.model.params, caches, torch.tensor([[cur]]), t, port.cfg,
            device="cpu")
        if t >= len(prompt) - 1:
            out.append(int(torch.argmax(logits[0, 0])))
    assert pr.out_tokens == out[:4] == rr.out_tokens


def test_server_stops_at_the_end_of_the_cache():
    """A request that would outgrow the cache completes at max_seq - 1,
    as the reference's does."""
    ref, port = servers("granite_3_2b", pool=2, max_seq=12)
    out = []
    for srv in (ref, port):
        r = srv.submit(list(range(1, 9)), max_new_tokens=50)
        stats = srv.run_until_drained()
        out.append((r.out_tokens, dataclasses.asdict(stats)))
    assert out[1] == out[0]
    assert len(out[1][0]) == 11 - 8 + 1
    assert int(port.pos.max()) == 11


def test_server_eos_and_custom_sampler():
    """EOS stops a request early; the sampler sees the (pool, vocab)
    float32 logits of every step."""
    _, port = servers("granite_3_2b", pool=2)
    seen = []

    def sampler(logits):
        seen.append(tuple(logits.shape))
        return torch.full((logits.shape[0],), 7)
    port.sampler = sampler
    r = port.submit([1, 2], max_new_tokens=10, eos_id=7)
    stats = port.run_until_drained()
    assert r.out_tokens == [7] and stats.completed == 1
    assert seen == [(2, port.cfg.vocab_size)] * 2


# ====================================================== every family

#: the families the port serves beyond dense attention; whisper's
#: reference serves one row at a time (queue 3), so it takes pool 1 here
FAMILIES = ("h2o_danube_3_4b", "mamba2_370m", "mixtral_8x7b",
            "qwen3_moe_235b_a22b", "jamba_v0_1_52b", "internvl2_26b",
            "whisper_medium")
PROMPTS = ([1, 2, 3], [5, 6, 7, 8, 9], [4, 2])


@pytest.mark.parametrize("arch", FAMILIES)
def test_fresh_slots_serve_like_the_reference(arch):
    """Requests on fresh slots (no slot recycled), positions inside
    danube's window: the same tokens and stats as the reference's."""
    prompts = PROMPTS[:1] if arch == "whisper_medium" else PROMPTS
    ref, port = servers(arch, pool=len(prompts))
    out = []
    for srv in (ref, port):
        reqs = [srv.submit(p, max_new_tokens=6) for p in prompts]
        stats = srv.run_until_drained()
        out.append(([r.out_tokens for r in reqs], dataclasses.asdict(stats)))
    assert out[1] == out[0]
    assert all(len(t) == 6 for t in out[1][0])


def alone(port, prompt, max_new):
    """``prompt`` served alone on a fresh pool-1 server of port's model."""
    srv = Server(port.cfg, port.model, pool=1, max_seq=port.max_seq,
                 device="cpu")
    r = srv.submit(prompt, max_new_tokens=max_new)
    srv.run_until_drained()
    return r.out_tokens


@pytest.mark.parametrize("arch", ["mamba2_370m", "jamba_v0_1_52b"])
def test_recycled_ssm_slots_serve_each_request_alone(arch):
    """Pool 1: the second request takes the first's slot.  The port zeroes
    the slot's conv and state rows on admission, so it serves the second
    request as if alone; the reference's carry the first request's state
    (ROADMAP queue 3)."""
    ref, port = servers(arch, pool=1)
    first, second = [1, 2, 3], [7, 8, 9, 10]
    out = {}
    for name, srv in (("ref", ref), ("port", port)):
        srv.submit(first, max_new_tokens=4)
        r = srv.submit(second, max_new_tokens=4)
        srv.run_until_drained()
        out[name] = r.out_tokens
    assert out["port"] == alone(port, second, 4)
    assert out["ref"] != out["port"]


def test_whisper_serves_a_pool_with_per_row_positions():
    """Whisper at pool 2: each row's sinusoidal position is its own, so
    every request gets the tokens it gets alone; the reference's server
    raises at pool 2 (its one broadcast position, queue 3)."""
    ref, port = servers("whisper_medium", pool=2)
    reqs = [port.submit(p, max_new_tokens=5) for p in PROMPTS]
    port.run_until_drained()
    for r, p in zip(reqs, PROMPTS):
        assert r.out_tokens == alone(port, p, 5)
    ref.submit(PROMPTS[0], max_new_tokens=2)
    ref.submit(PROMPTS[1], max_new_tokens=2)
    with pytest.raises(ValueError, match="broadcast"):
        ref.step()


# ================================================================ rules

def test_serving_entry_points_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = get_config("granite_3_2b", smoke=True)
    model = port_model.Model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        Server(cfg, model)
    with pytest.raises(RuntimeError, match="cuda"):
        launch_serve.main(["--arch", "granite_3_2b", "--smoke"])


def test_launch_serve_cpu_summary(capsys):
    assert launch_serve.main(["--arch", "granite_3_2b", "--smoke",
                              "--requests", "3", "--pool", "2",
                              "--max-new", "4", "--max-seq", "32",
                              "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[launch.serve] 3 done, 12 tokens, ")
    assert line.endswith(" pool steps")


SERVE_ABSENT = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
from repro_torch.configs.base import get_config
from repro_torch.launch.serve import serve
out = serve(get_config("llama3_2_3b", smoke=True), requests=3, pool=2,
            max_new=4, max_seq=32, device="cpu")
assert out["stats"].completed == 3
assert all(len(r.out_tokens) == 4 for r in out["requests"])
assert not any(m.startswith(("jax.", "repro.")) for m in sys.modules)
print("served", out["stats"].steps)
"""


def test_serve_path_runs_with_jax_and_repro_absent():
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", SERVE_ABSENT], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("served ")
