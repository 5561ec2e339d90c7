"""One rank of a gloo world for tests/test_torch_parallel.py.

    python tests/torch_dist_worker.py <spec.json> <rank>

joins the world that the spec names (``address``, ``world``) on the CPU
and runs its scenarios in order, each rank alike, writing
``<out>/<scenario>.r<rank>.npz``: the trainable parameters after training
(``p/<name>``), Adam's step count, the dropout masks that the train
forwards applied (``k/<i>``, in order), the rank's word table (its shard
under ``--shard_embedding``), the per-step losses and the metrics events.
The test runs the same scenario functions in its own process, with no
process group, for the 1-rank references, which also keep each
parameter's RMS gradient (``grad_rms``).  Nothing here imports JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
from types import SimpleNamespace

from unittest import mock

import numpy as np
import torch

from chip_smoke import grad_rms
from umpr_tpu_torch.config import Config
from umpr_tpu_torch.data.dataset import UMPRDataset
from umpr_tpu_torch.models import visual_net
from umpr_tpu_torch.models.umpr import UMPR, ModelDims
from umpr_tpu_torch.parallel import multihost
from umpr_tpu_torch.parallel.mesh import setup_runtime
from umpr_tpu_torch.text.vocab import Word2vec
from umpr_tpu_torch.train.optim import make_optimizer
from umpr_tpu_torch.train.step import train_step
from umpr_tpu_torch.train.trainer import Trainer
from umpr_tpu_torch.utils.logging import get_logger


def steps_scenario(sc, flags=()):
    """UMPR-R train steps on the batches saved at ``sc["data"]`` (``emb``,
    the state ``p/<name>``, batch i's fields ``b<i>/<field>``): each rank
    ships its rows of every global batch, as the Trainer's loader does."""
    data = np.load(sc["data"])
    model = UMPR(ModelDims(**sc["dims"]), data["emb"])
    model.load_state_dict({k[2:]: torch.from_numpy(data[k]) for k in data.files
                           if k.startswith("p/")})
    n_batches = 1 + max(int(k[1:k.index("/")]) for k in data.files if k.startswith("b"))
    B = data["b0/sample_mask"].shape[0]
    mesh = setup_runtime(SimpleNamespace(mesh_shape=sc.get("mesh_shape", []), batch_size=B,
                                         torch_device=torch.device("cpu")))
    rows = None if mesh is None else mesh.rows(B)
    opt = make_optimizer(model, sc["l2"], sc["lr"])
    losses = []
    for i in range(n_batches):
        batch = {k.split("/")[1]: data[k] for k in data.files if k.startswith(f"b{i}/")}
        loss, _ = train_step(model, opt, multihost.put_local(batch, "cpu", rows), sc["lr"],
                             mesh=mesh)
        losses.append(float(loss))
    return {"losses": losses, "events": [],
            "params": {n: p.detach().numpy().copy() for n, p in model.named_parameters()
                       if p.requires_grad},
            "grad_rms": grad_rms(opt), "steps": int(opt.count), "keep": [],
            "table": model.embedding.weight.detach().numpy().copy()}


def fit_scenario(sc, flags=()):
    """``Trainer.fit`` and ``test`` on the split caches under ``sc["data"]``
    with ``sc["argv"]`` (plus this rank's world flags); the metrics events
    are kept on every rank."""
    cfg = Config(list(sc["argv"]) + list(flags))
    trainer = Trainer(cfg, get_logger(logger_name=f"fit-{sc['name']}"),
                      Word2vec(cfg.word2vec_file))
    events = []
    trainer._metric = lambda event, **kv: events.append(
        {"event": event, **{k: v for k, v in kv.items() if k != "elapsed_s"}})
    ds = {s: UMPRDataset.load(os.path.join(sc["data"], f"dataset_{s}.cache"))
          for s in ("train", "valid", "test")}
    keep, dropout = [], visual_net.dropout

    def recorded(x, drop):
        # the mask that the forward applies, drawn as dropout draws it
        if isinstance(drop, torch.Generator):
            drop = visual_net.keep_mask(x.shape, drop, x.device)
        keep.append(drop.cpu().numpy().copy())
        return dropout(x, drop)

    with mock.patch.object(visual_net, "dropout", recorded):
        trainer.fit(ds["train"], ds["valid"], cfg.model_path)
    trainer.test(ds["test"], cfg.model_path)
    if not sc.get("keep_run"):  # test() has read best/ on every rank
        shutil.rmtree(cfg.model_path, ignore_errors=True)
    return {"losses": [], "events": events,
            "params": {n: p.detach().cpu().numpy().copy()
                       for n, p in trainer.model.named_parameters() if p.requires_grad},
            "grad_rms": grad_rms(trainer.opt), "steps": int(trainer.opt.count), "keep": keep,
            "table": trainer.model.embedding.weight.detach().cpu().numpy().copy()}


SCENARIOS = {"steps": steps_scenario, "fit": fit_scenario}


def run(sc, flags=()):
    return SCENARIOS[sc["kind"]](sc, flags)


def save(result, path):
    np.savez(path, losses=np.asarray(result["losses"], np.float64),
             events=np.asarray(json.dumps(result["events"])), table=result["table"],
             steps=result["steps"], **{f"p/{k}": v for k, v in result["params"].items()},
             **{f"k/{i:05d}": v for i, v in enumerate(result["keep"])})


def load(path):
    with np.load(path) as z:
        return {"losses": z["losses"], "events": json.loads(str(z["events"])),
                "table": z["table"],
                "params": {k[2:]: z[k] for k in z.files if k.startswith("p/")},
                "steps": int(z["steps"]),
                "keep": [z[k] for k in sorted(z.files) if k.startswith("k/")]}


def main(spec_path, rank):
    spec = json.load(open(spec_path))
    torch.set_num_threads(spec.get("threads", 1))
    multihost.initialize(spec["address"], spec["world"], rank, device=torch.device("cpu"))
    flags = ["--coordinator_address", spec["address"], "--num_processes",
             str(spec["world"]), "--process_id", str(rank)]
    for sc in spec["scenarios"]:
        save(run(sc, flags), os.path.join(spec["out"], f"{sc['name']}.r{rank}.npz"))
    multihost.shutdown()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
