"""The port's eval CLI (``python -m rajni_tpu_torch.run``) with the parallel
flags, on the CPU: two ``--distributed`` processes (``--coordinator``,
``--num_processes``, ``--process_id``) each print the global accuracy that
one process computes on the union of their data shards; ``--tensor_parallel
2`` spawns its two ranks, prints its ``route:`` line (the gloo backend, each
rank's device) and agrees with the single-process run.

``vit_small_patch16_64`` (6 heads of 64, 17 tokens) in fp32, one torch
thread a process. The accuracies are printed to two decimals and compared as
printed; random weights on random labels make them near zero, so the check
that counts is that every process prints the same global line as the one
process.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rajni_tpu_torch.data.pipeline import SyntheticLoader
from rajni_tpu_torch.models.wrapper import RAJNIViT
from rajni_tpu_torch.parallel.launch import free_port

ROOT = Path(__file__).resolve().parent.parent
MODEL = "vit_small_patch16_64"
COMMON = ["--model", MODEL, "--device", "cpu", "--dtype", "float32", "--warmup", "1",
          "--no-progress"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sched(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "s.json"
    path.write_text(json.dumps({"3": {"keep_ratio": 0.7}, "6": {"keep_ratio": 0.8}}))
    return path


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    env.pop("WORLD_SIZE", None)
    return env


def _acc(out: str) -> str:
    line = [ln for ln in out.splitlines() if ln.startswith("RAJNI - ")]
    assert line, out
    return re.search(r"Accuracy: ([0-9.]+)%", line[0]).group(1)


def test_distributed_two_processes(sched):
    """Every process prints the single-process accuracy over both shards."""
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "rajni_tpu_torch.run", "--distributed", "--coordinator",
         f"localhost:{port}", "--num_processes", "2", "--process_id", str(i), "--synthetic",
         "2", "--batch_size", "4", "--schedule", str(sched), *COMMON],
        env=_env(), cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, f"{out}\n{err}"
        assert "Distributed: process" in out and "route: torch (gloo, 2 ranks" in out, out
        outs.append(out)
    # one process on the union of the shards (each rank's synthetic seed)
    model = RAJNIViT(MODEL, json.loads(sched.read_text()), seed=0, dtype=torch.float32,
                     device="cpu")
    correct = total = 0
    for pid in range(2):
        images, labels = next(iter(SyntheticLoader(1, 2, 64, 1000, seed=100003 * pid)))
        preds = model(torch.from_numpy(images)).argmax(-1).numpy()
        correct += int((preds == labels).sum())
        total += len(labels)
    want = f"{100.0 * correct / total:.2f}"
    assert [_acc(o) for o in outs] == [want, want]


def test_tensor_parallel_two_ranks(sched):
    """``--tensor_parallel 2`` on the kernels' plain versions: the route
    line, and the single-process run's accuracy and token counts."""
    args = ["--synthetic", "2", "--batch_size", "4", "--schedule", str(sched), "--kernels",
            "cuda", *COMMON]
    outs = [subprocess.run([sys.executable, "-m", "rajni_tpu_torch.run", *extra, *args],
                           env=_env(), cwd=ROOT, capture_output=True, text=True, timeout=120)
            for extra in (["--tensor_parallel", "2"], [])]
    for p in outs:
        assert p.returncode == 0, f"{p.stdout}\n{p.stderr}"
    tp, single = outs[0].stdout, outs[1].stdout
    assert "route: cuda (gloo, 2 ranks: cpu, cpu)" in tp, tp
    assert "route: cuda\n" in single, single
    counts = [re.search(r"Token counts per block: (.*)", o).group(1) for o in (tp, single)]
    assert counts[0] == counts[1]
    assert _acc(tp) == _acc(single)
    assert np.isfinite(float(re.search(r"Throughput: ([0-9.]+)", tp).group(1)))
