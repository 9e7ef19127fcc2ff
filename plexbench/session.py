"""What every kind of mix does alike: the cluster, the jobs' deployments
with the seed's weights, the matching of the window's spans to the port's
exec and switch logs, and the tear-down."""
from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import Dict, List

import torch

from plexbench import weights as wts

# the port's ModelConfig field for each size of a configuration file
PORT_FIELDS = {
    "num_hidden_layers": "num_layers", "hidden_size": "d_model",
    "num_attention_heads": "num_heads", "num_key_value_heads": "num_kv_heads",
    "head_dim": "head_dim", "intermediate_size": "d_ff",
    "vocab_size": "vocab_size", "attention_bias": "qkv_bias",
    "tie_word_embeddings": "tie_embeddings", "rope_theta": "rope_theta",
    "rms_norm_eps": "norm_eps",
}


def port_overrides(cfg: dict) -> tuple:
    """The port's config fields that differ from its registry entry: none
    for a configuration as published; the sizes of a reduced one. A
    difference the file does not list in ``reduced`` is an error: the port
    would not run what the file says."""
    from repro_torch.configs import get_config
    reg = get_config(cfg["registry"])
    over = []
    for key, field in PORT_FIELDS.items():
        if getattr(reg, field) != cfg[key]:
            if key not in cfg["reduced"]:
                raise ValueError(f"{cfg['registry']}: the port has {field}="
                                 f"{getattr(reg, field)}, the file {key}="
                                 f"{cfg[key]}")
            over.append((field, cfg[key]))
    if reg.param_dtype != cfg["torch_dtype"]:
        raise ValueError(f"the port stores {reg.param_dtype}")
    return tuple(over)


_BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def bits_mismatch(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements whose bits differ (two leaves of one dtype and size; a
    leaf of another dtype or size differs in every element)."""
    if a.dtype != b.dtype or a.numel() != b.numel():
        return max(a.numel(), b.numel())
    bits = _BITS[a.element_size()]
    return int((a.reshape(-1).view(bits) != b.reshape(-1).to(
        a.device).view(bits)).sum())


def norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.float()))


class BaseSession:
    """``role``: the deployments' role; ``rate_metric``: the end-to-end rate
    this kind reports."""

    role = "train"
    rate_metric = ""

    def __init__(self, cell, seed: int, device: str, cluster_kwargs=None):
        self.cell = cell
        self.seed = seed
        self.device = torch.device(device)
        self.cfg = cell.config
        self.mix = cell.traffic
        self.jobs = self.mix["jobs"]
        self.ref = cell.module("reference")
        self.port = cell.module("port")
        self.cluster_kwargs = cluster_kwargs or {}
        self.overrides = port_overrides(self.cfg)
        self.deps: List = []

    # ----------------------------------------------------------- set-up
    def make_cluster(self):
        from repro_torch.core.cluster import PlexCluster
        from repro_torch.core.worker import WorkerProcessGroup
        from repro_torch.rl.grpo import GRPOConfig
        from repro_torch.train.optimizer import AdamWConfig
        kw = {}
        if "optimizer" in self.cfg:
            kw["adamw_cfg"] = AdamWConfig(**self.cfg["optimizer"])
        if "grpo" in self.cfg:
            kw["grpo_cfg"] = GRPOConfig(**self.cfg["grpo"])
        factory = functools.partial(WorkerProcessGroup, **kw)
        return PlexCluster(n_groups=1, wpg_factory=factory,
                           **self.cluster_kwargs)

    def deploy(self):
        """The cluster serving, a deployment a job on group 0, each INIT
        with the job's weights drawn on the device from the seed."""
        from repro_torch.core import api
        self.cluster = self.make_cluster()
        self.router = self.cluster.router
        self.router.serve()
        for j in range(self.jobs):
            spec = api.DeploymentSpec(
                deployment_id=f"job{j}-{self.role}", job_id=f"job{j}",
                model_name=self.cfg["registry"], role=self.role,
                overrides=self.overrides)
            dep = self.router.deploy(spec, group_id=0)
            w = wts.make_weights(self.cfg, self.seed, j, self.device)
            dep.call(api.Op.INIT, self.seed,
                     params=self.port.to_port(self.cfg, w)).wait()
            del w
            self.deps.append(dep)

    def mark(self):
        """The logs' positions where the window starts."""
        self.exec_mark = [d.wpg.exec_log.total() for d in self.deps]
        self.switch_mark = len(self.router.switch_log)

    def leaf_mismatch(self, job: int) -> int:
        """Elements of a resident job's parameters whose bits differ from
        the weights handed to its INIT, drawn again from the seed."""
        tree = self.port.by_reference_name(self.deps[job].wpg.params())
        return sum(bits_mismatch(t, wts.make_leaf(self.cfg, self.seed, job,
                                                  name, self.device))
                   for name, t in tree.items())

    # ------------------------------------------------------------ window
    def keep(self, job: int, k: int, span: dict, result):
        """Hold what the check needs of an op's result."""

    def after_window(self, win) -> SimpleNamespace:
        """Every op finished; each span matched to its exec-log seconds
        (a job's ops execute in its order) and to the switch that loaded
        its job."""
        self.router.wait_idle(timeout=120)
        spans = sorted(win.spans, key=lambda s: (s["job"], s["k"]))
        for j, dep in enumerate(self.deps):
            entries, _ = dep.wpg.exec_log.since(self.exec_mark[j])
            mine = [s for s in spans if s["job"] == j and s["ok"]]
            for s, (op, sec) in zip(mine, entries):
                s["exec_s"] = sec if op == s["op"] else None
        switches = list(self.router.switch_log[self.switch_mark:])
        for s in spans:
            s["switch_s"] = 0.0
            for sw in switches:
                if sw["to_job"] == f"job{s['job']}" and \
                        s["submit"] <= sw["t"] <= s["resolve"]:
                    s["switch_s"] += sw["t_offload"] + sw["t_load"]
        return SimpleNamespace(spans=spans, switches=switches)

    def free(self):
        """Stop the dispatch plane and drop the program's state."""
        if getattr(self, "router", None) is not None:
            self.router.shutdown(timeout=120)
        self.deps = []
        self.cluster = self.router = None

    def to_device(self, batch: Dict) -> Dict[str, torch.Tensor]:
        out = {k: torch.as_tensor(v, device=self.device)
               for k, v in batch.items()}
        out["tokens"] = out["tokens"].long()
        return out
