"""PlexCluster: the runnable binding of Scheduler + Router + StateManagers.

The port of ``repro.core.cluster``. Runs real model execution on the
node groups' devices (the CUDA card by default; a ``device_plane`` over the
CPU for tests): multiple RLVR jobs share node groups, HRRS orders their
function requests, and context switches move model state through the
StateManager tiers.

Two operating modes:

- :meth:`run` — batch: every registered job is driven to completion under
  shared scheduling (the isolated/multiplexed comparisons of
  examples/multiplex_rlvr.py, and the fault-tolerance tests).
- :meth:`serve` — serviceized (the paper's §4.1 regime): the Router's
  persistent dispatch plane runs continuously, :meth:`add_job` attaches a
  job mid-flight (each controller self-drives on its own client thread),
  :meth:`remove_job` detaches one (queued ops cancel, in-flight ops
  resolve), and billing stays incremental throughout.

Jobs run GRPO (``algo="grpo"``) or PPO (``algo="ppo"``: an actor and a
critic deployment). :meth:`checkpoint_all` materialises every deployment's
parameters and :meth:`restore_all` loads them back, after
:meth:`fail_node` too. With ``process_plane=True`` each node group's WPGs
run in their own worker process (``launch/proc_plane.py``); there, as in
the reference, :meth:`fail_node`, :meth:`checkpoint_all` and
:meth:`restore_all` fail (checkpoints go through the deployments'
``save_checkpoint`` / ``load_checkpoint`` ops instead).
``devices_per_group`` sizes each group's device slice (the Router's
``DevicePlane(slice_size=)``): a group of several devices runs its
deployments over its slice (tensor, expert and SSD-head parallel), in
thread mode or in its process-plane child, which sees the slice's devices;
a migration across groups reshards onto the destination's slice, and the
bills come from the exec logs (the children's, mirrored in this
process).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

from repro_torch.core import api
from repro_torch.core import tenancy
from repro_torch.core.control_plane import DirectorConfig, PlacementDirector
from repro_torch.core.controller import (JobConfig, RLControllerGRPO,
                                         RLControllerPPO, _RLControllerBase)
from repro_torch.core.router import Router
from repro_torch.core.state_manager import Tier
from repro_torch.launch.mesh import DevicePlane

CONTROLLER_TYPES = {"grpo": RLControllerGRPO, "ppo": RLControllerPPO}


@dataclasses.dataclass
class BillingRecord:
    job_id: str
    busy_seconds: float = 0.0         # execution attributed to the job
    switch_seconds: float = 0.0       # setup overhead it caused
    steps: int = 0

    def gpu_seconds_per_step(self) -> float:
        return (self.busy_seconds + self.switch_seconds) / max(self.steps, 1)


class PlexCluster:
    def __init__(self, n_groups: int = 1, policy: str = "hrrs",
                 wpg_factory=None,
                 director_cfg: Optional[DirectorConfig] = None,
                 devices_per_group: Optional[int] = None,
                 process_plane: bool = False,
                 proc_wpg_factory: Optional[str] = None,
                 device_plane: Optional[DevicePlane] = None):
        """``device_plane`` leases each node group its device slice; the
        default plane carves the CUDA devices (and raises without one)
        into slices of ``devices_per_group``. ``process_plane`` and
        ``proc_wpg_factory`` go to the Router."""
        kwargs = {} if wpg_factory is None else {"wpg_factory": wpg_factory}
        self.router = Router(policy=policy, device_plane=device_plane,
                             devices_per_group=devices_per_group,
                             process_plane=process_plane,
                             proc_wpg_factory=proc_wpg_factory, **kwargs)
        self.controllers: Dict[str, _RLControllerBase] = {}
        self.billing: Dict[str, BillingRecord] = {}
        # incremental billing cursors: exec-log offset per deployment and
        # consumed prefix of the router's switch log
        self._billed_ops: Dict[str, int] = {}
        self._billed_switches = 0
        self._bill_lock = threading.Lock()
        # serve mode
        self._serving = False
        # serializes client-thread launches against serve() startup so a
        # concurrent add_job can never double-drive one controller
        self._serve_lock = threading.RLock()
        self._job_threads: Dict[str, Tuple[threading.Thread,
                                           threading.Event]] = {}
        self._removed_jobs: set = set()
        self.client_errors: Dict[str, BaseException] = {}
        for g in range(n_groups):
            # ensure_group leases each group its mesh slice from the
            # router's device plane (disjoint hardware per group when the
            # process has enough devices; shared lone slice otherwise)
            self.router.ensure_group(g)
        # multi-tenant service layer: registry (who exists), ledger
        # (per-tenant accounting + SLO windows), admission controller
        # (quotas + pending queues). The default tenant is implicit, so an
        # untenanted cluster behaves exactly as before.
        dcfg = director_cfg or DirectorConfig()
        self.tenants = tenancy.TenantRegistry()
        self.tenant_ledger = tenancy.TenantLedger(
            self.tenants, slo_window=dcfg.slo_window,
            slo_min_samples=dcfg.slo_min_samples)
        self.admission = tenancy.AdmissionController(self.tenants,
                                                     self.tenant_ledger)
        self.router.tenant_ledger = self.tenant_ledger
        # the live control plane: online profiler + automatic placement +
        # capacity adjustment over this router's node groups (tenancy gives
        # it the SLO-preemption trigger's inputs)
        self.director = PlacementDirector(self.router, cfg=director_cfg,
                                          initial_groups=range(n_groups),
                                          tenancy=self.tenant_ledger)

    # ------------------------------------------------------------- jobs
    def register_tenant(self, spec: tenancy.TenantSpec) -> tenancy.TenantSpec:
        """Register (or replace — how an operator tightens a live SLO) a
        tenant's policy. Jobs name their tenant via ``JobConfig.tenant``."""
        return self.tenants.register(spec)

    def add_job(self, cfg: JobConfig, group_id: Optional[int] = 0,
                algo: str = "grpo",
                queue_on_deny: bool = False) -> Optional[_RLControllerBase]:
        """Attach a job. Outside serve mode it is registered for the next
        :meth:`run`; against a live :meth:`serve` plane it starts making
        progress immediately on its own client thread (spawning a dispatch
        worker for ``group_id`` if the group is new).

        ``group_id=None`` routes placement through the control plane: the
        :class:`~repro_torch.core.control_plane.PlacementDirector`
        cold-places the job on a dedicated profiling group (spawning one if
        needed), then — after one clean profiled cycle — re-fits it by
        micro-shift trace fitting and migrates it onto a shared group
        automatically.

        Every submission passes tenancy admission first: a job whose tenant
        is at quota (groups or gpu-seconds) or for which no feasible
        placement exists is rejected with a typed
        :class:`~repro_torch.core.tenancy.AdmissionDenied` — or, with
        ``queue_on_deny=True``, parked in its tenant's pending queue
        (returns None) and replayed automatically when :meth:`remove_job`
        frees capacity. Unknown tenants are always a hard denial."""
        tenant_id = getattr(cfg, "tenant", tenancy.DEFAULT_TENANT)
        reason = self.admission.check(
            tenant_id, cfg.job_id, self.director.placement_feasible())
        if reason is not None:
            if queue_on_deny and reason != tenancy.REASON_UNKNOWN_TENANT:
                self.admission.enqueue(tenant_id, tenancy.PendingJob(
                    cfg=cfg, group_id=group_id, algo=algo,
                    enqueued_t=self.router.now()))
                return None
            raise tenancy.AdmissionDenied(tenant_id, cfg.job_id, reason)
        self.admission.admit(tenant_id, cfg.job_id)
        return self._launch_admitted(cfg, group_id, algo)

    def _launch_admitted(self, cfg: JobConfig, group_id: Optional[int],
                         algo: str) -> _RLControllerBase:
        """Attach a job whose admission is already decided (quota
        reserved): bind its tenant, stamp its HRRS priority, place, and
        launch. Shared by :meth:`add_job` and the pending-queue drain."""
        tenant_id = getattr(cfg, "tenant", tenancy.DEFAULT_TENANT)
        spec = self.tenants.get(tenant_id) or tenancy.default_spec()
        self.tenant_ledger.bind_job(cfg.job_id, tenant_id)
        self.router.register_job_tenant(cfg.job_id, tenant_id,
                                        priority=spec.priority)
        if group_id is None:
            group_id = self.director.assign(cfg.job_id)
        ctl = CONTROLLER_TYPES[algo](cfg, self.router, group_id=group_id)
        self.controllers[cfg.job_id] = ctl
        # a re-attached job keeps accruing on its existing bill — charges
        # from before a detach are an invoice, not scratch state
        self.billing.setdefault(cfg.job_id, BillingRecord(cfg.job_id))
        self._removed_jobs.discard(cfg.job_id)
        with self._serve_lock:
            # under the lock serve() uses for its own launch sweep: the
            # controller is registered above, so a racing serve() either
            # sweeps it up or we observe _serving here — never neither,
            # and _launch_client's registry check means never both
            if self._serving:
                self._launch_client(ctl)
        return ctl

    def remove_job(self, job_id: str) -> Optional[_RLControllerBase]:
        """Detach a job mid-flight (callable from any thread while serving).

        The client thread stops submitting, the job's deployments tear down
        (queued ops cancel with an error; a RUNNING op completes and
        resolves its future), and everything the job executed — including
        work finished during the detach — is billed."""
        with self._serve_lock:
            entry = self._job_threads.pop(job_id, None)
            self._removed_jobs.add(job_id)
        if entry is not None:
            entry[1].set()
        with self.router.executor.cv:
            dead = {d: self.router.wpgs[d]
                    for d, s in self.router.deployments.items()
                    if s.job_id == job_id}
        for dep_id in dead:
            self.router.teardown(dep_id)
        if entry is not None:
            entry[0].join(timeout=120.0)
        # teardown already drained each dead deployment's in-flight ops
        # before returning (their exec-log entries exist), and this is the
        # LAST billing pass that can see the torn-out WPGs
        with self._bill_lock:
            self._bill_from_logs(extra_wpgs=dead)
            # drop the dead deployments' billing cursors: a later add_job
            # under the same job_id creates FRESH WPGs with empty exec logs
            # under the same deployment ids, and a stale cursor would skip
            # their first N ops
            for dep_id in dead:
                self._billed_ops.pop(dep_id, None)
        # control plane: release the job's placement and retire any group
        # the departure left idle (no-op for jobs it never managed)
        self.director.on_job_removed(job_id)
        # tenancy: drop the quota reservation (after billing, so the final
        # gpu-seconds land on the right tenant), then replay any pending
        # submissions the freed capacity now admits
        self.admission.release(job_id)
        self.tenant_ledger.unbind_job(job_id)
        for pending in self.admission.drain(self.director.placement_feasible):
            self._launch_admitted(pending.cfg, pending.group_id, pending.algo)
        return self.controllers.get(job_id)

    # ------------------------------------------------------------ serve
    @contextlib.contextmanager
    def serve(self):
        """Persistent serve mode: ``with cluster.serve(): ...``.

        Jobs added before or during the block self-drive against the live
        plane; the block body attaches/detaches jobs or does other work. On
        exit, remaining client threads are joined (jobs run to completion),
        the plane shuts down, and any client-thread failure is re-raised.
        """
        if self._serving:
            raise RuntimeError("already serving")
        self.router.serve()
        self.client_errors = {}
        with self._serve_lock:
            self._serving = True
            controllers = list(self.controllers.values())
            for ctl in controllers:
                # relaunch guard: a removed job stays detached and a job
                # that already completed every step is not re-driven by a
                # later serve session (its deployment state persists)
                if (ctl.cfg.job_id in self._removed_jobs
                        or ctl.steps_completed >= ctl.cfg.steps):
                    continue
                self._launch_client(ctl)
        body_failed = False
        try:
            yield self
            # join to quiescence: a job attached from another thread WHILE
            # we were joining must also complete, so loop until no client
            # thread is alive and close the attach window (_serving=False)
            # under the same lock add_job uses before breaking out
            while True:
                for t, _ in list(self._job_threads.values()):
                    t.join()
                with self._serve_lock:
                    if all(not t.is_alive()
                           for t, _ in self._job_threads.values()):
                        self._serving = False
                        break
        except BaseException:
            body_failed = True
            with self._serve_lock:
                self._serving = False     # stop accepting new launches
            # body failed: detach every still-driving job so its client
            # thread unblocks promptly (teardown poisons outstanding ops)
            # instead of being orphaned against a dead plane
            for job_id in list(self._job_threads):
                try:
                    self.remove_job(job_id)
                except Exception:       # noqa: BLE001 - best-effort detach
                    pass
            raise
        finally:
            self._serving = False
            self._job_threads = {}
            try:
                self.router.shutdown()
            except RuntimeError as shut_err:
                # shutdown reports user-callback errors; never let that
                # REPLACE an exception already propagating from the body
                if not body_failed:
                    raise
                self.client_errors.setdefault("<callbacks>", shut_err)
            with self._bill_lock:
                self._bill_from_logs()
        if self.client_errors:
            job, err = next(iter(self.client_errors.items()))
            raise RuntimeError(
                f"job {job!r} client thread failed: {err!r}") from err

    def _launch_client(self, ctl: _RLControllerBase):
        job_id = ctl.cfg.job_id
        with self._serve_lock:
            if job_id in self._job_threads:
                return                # already driven (serve/add_job race)
            stop = threading.Event()
            rec = self.billing[job_id]

            def step_hook():
                with self._bill_lock:
                    rec.steps += 1
                    self._bill_from_logs()
                # control-plane tick OUTSIDE the billing lock: it may block
                # on a migration drain (profiling -> warm re-placement)
                self.director.on_job_step(job_id)

            def client():
                try:
                    ctl.drive(stop=stop, step_hook=step_hook)
                except BaseException as e:  # noqa: BLE001 - surfaced at exit
                    self.client_errors[job_id] = e

            t = threading.Thread(target=client, name=f"client-{job_id}",
                                 daemon=True)
            self._job_threads[job_id] = (t, stop)
        t.start()

    # -------------------------------------------------------------- run
    def run(self, interleave: bool = True,
            concurrent: bool = False) -> Dict[str, BillingRecord]:
        """Run every job to completion under shared scheduling.

        With ``interleave`` the controllers submit steps round-robin so the
        HRRS queue actually multiplexes; without it jobs run back-to-back
        (the 'isolated' baseline on the same hardware). With ``concurrent``
        the router's event-driven dispatch plane executes different node
        groups on parallel worker threads (``run_until_idle``), so jobs
        placed on different groups genuinely overlap in wall-clock time;
        otherwise the serial driver (``drain``) is used.
        """
        def drive():
            if concurrent:
                self.router.run_until_idle()
            else:
                self.router.drain()
            with self._bill_lock:
                self._bill_from_logs()

        # jobs detached by remove_job stay detached (their deployments are
        # gone), and a job a prior serve() session already completed is not
        # re-driven; partially-driven jobs resume from where they stopped
        active = {j: c for j, c in self.controllers.items()
                  if j not in self._removed_jobs
                  and c.steps_completed < c.cfg.steps}
        tails: List[api.Future] = []
        for ctl in active.values():
            if ctl.steps_completed == 0:       # resumed jobs keep weights
                tails.append(ctl.submit_init())
        drive()

        remaining = {j: c.cfg.steps - c.steps_completed
                     for j, c in active.items()}
        order = list(active)
        while any(v > 0 for v in remaining.values()):
            stepped: List[str] = []
            for job_id in order:
                if remaining[job_id] <= 0:
                    continue
                tails += active[job_id].submit_step()
                remaining[job_id] -= 1
                if not interleave:
                    drive()
                    self.director.on_job_step(job_id)
                else:
                    stepped.append(job_id)
            if interleave:
                drive()
                for job_id in stepped:
                    self.director.on_job_step(job_id)
        drive()
        for f in tails:
            f.result()                # surface failed steps loudly
        for job_id, ctl in active.items():
            ctl.steps_completed = ctl.cfg.steps
            self.billing[job_id].steps = ctl.cfg.steps
        return self.billing

    def _bill_from_logs(self, extra_wpgs: Optional[Dict[str, object]] = None):
        """Attribute measured execution time per job from WPG exec logs and
        switch overheads from the router's switch log (unified provisioning:
        §7.2 — users pay for the computation they consume).

        Incremental: only log entries beyond each cursor are consumed, and
        busy time ACCUMULATES across a job's deployments (a job with split
        train/rollout WPGs is billed for both). ``extra_wpgs`` lets a detach
        bill a deployment that was already torn out of the router. Callers
        hold ``_bill_lock`` (client threads bill concurrently)."""
        with self.router.executor.cv:
            items = list(self.router.wpgs.items())
        if extra_wpgs:
            seen = {d for d, _ in items}
            items += [(d, w) for d, w in extra_wpgs.items() if d not in seen]
        for dep_id, wpg in items:
            rec = self.billing.get(wpg.spec.job_id)
            if rec is None:
                continue
            start = self._billed_ops.get(dep_id, 0)
            log = wpg.exec_log
            if hasattr(log, "since"):      # bounded ring: absolute cursors
                new, cursor = log.since(start)
            else:                          # plain list (test/bench stubs)
                new = log[start:]
                cursor = start + len(new)
            self._billed_ops[dep_id] = cursor
            busy = sum(dt for _, dt in new)
            rec.busy_seconds += busy
            # tenant fold of the same cursors: billing and quota read one
            # meter (a preempted job's RUNNING op completes, logs, and is
            # billed here like any other — preemption never strands charges)
            self.tenant_ledger.add_gpu_seconds(
                self.tenant_ledger.tenant_of(wpg.spec.job_id), busy)
        for ev in self.router.switch_log[self._billed_switches:]:
            rec = self.billing.get(ev["to_job"])
            if rec is not None:
                rec.switch_seconds += ev["t_offload"] + ev["t_load"]
                self.tenant_ledger.add_gpu_seconds(
                    self.tenant_ledger.tenant_of(ev["to_job"]),
                    ev["t_offload"] + ev["t_load"])
        self._billed_switches = len(self.router.switch_log)

    # --------------------------------------------------- fault tolerance
    def _in_process(self, what: str):
        """Process mode's failure where the reference's reaches into state
        that lives in a worker process (an AttributeError there too)."""
        if self.router.process_plane:
            raise AttributeError(
                f"PlexCluster.{what} reads entry tiers and calls WPG methods "
                "in this process, but in process mode both live in the "
                "group's worker process; kill the process (respawn_dead_"
                "groups) or use the save_checkpoint / load_checkpoint ops")

    def fail_node(self, group_id: int):
        """Simulate a node failure: device-tier state on the group is lost.
        Jobs must restart from their last checkpoint (or re-init)."""
        sm = self.router.state_managers[group_id]
        if sm.entries:
            self._in_process("fail_node")
        lost = [k for k, e in sm.entries.items() if e.tier == Tier.DEVICE]
        for k in lost:
            sm.unregister([k])
        return lost

    def checkpoint_all(self, base_dir: str) -> Dict[str, str]:
        """Materialise every deployment's parameters under
        ``base_dir/<deployment id>``, whichever tier holds them. Returns
        deployment id -> checkpoint path."""
        if self.router.wpgs:
            self._in_process("checkpoint_all")
        paths = {}
        for dep_id, wpg in self.router.wpgs.items():
            paths[dep_id] = wpg._op_save_checkpoint(f"{base_dir}/{dep_id}")
        return paths

    def restore_all(self, paths: Dict[str, str]):
        """Load each deployment's checkpoint back (into the tensors it
        holds, or registered anew on its group's device after
        :meth:`fail_node`)."""
        if paths:
            self._in_process("restore_all")
        for dep_id, path in paths.items():
            self.router.wpgs[dep_id]._op_load_checkpoint(path)

    def migrate_job(self, job_id: str, src_group: int, dst_group: int):
        """Elastic re-placement: move a job's managed state across groups
        (paper §4.5.3 cross-node migration). Lives on the Router now; kept
        here as the historical entry point."""
        return self.router.migrate_job(job_id, src_group, dst_group)

    def reassign_job(self, job_id: str, dst_group: int,
                     timeout: float = 120.0) -> int:
        """Live re-placement: drain the job's in-flight ops, migrate its
        state, re-home its queued ops (billing stays continuous)."""
        return self.router.reassign_job(job_id, dst_group, timeout=timeout)

    # ------------------------------------------------------ reconciliation
    def reconcile(self, force: bool = True):
        """Run the control plane's reconcile pass now (§4.3.2's repacking
        loop): measure realized-vs-planned occupancy, plan an incremental
        repack, and realize its moves as batched live migrations. The
        per-step hooks run the same pass on its periodic cadence; this is
        the explicit entry point for external control loops / operators.
        Returns the list of realized moves."""
        return self.director.reconcile_now(force=force)

    def cluster_plan(self):
        """The declarative desired state (job → (group, shift, trace) plus
        the group set), versioned per placement change."""
        return self.director.cluster_plan()
