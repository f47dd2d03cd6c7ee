"""True multi-host execution: jax.distributed over N processes.

SURVEY.md §2.8's plan names two distribution channels: (a)
device-device XLA collectives over a sharded mesh (parallel/mesh.py) and
(b) the host-control RPC channel (backend/ipc.py). This module adds the
multi-HOST form of (a): `jax.distributed.initialize` joins N processes
(hosts of a cluster, or — for "multi-node without a cluster" testing,
SURVEY §4.7 — local CPU processes with gloo
cross-process collectives) into one global device mesh; GSPMD then
shards programs over every host's devices exactly as it does single-host
(mesh.py's named-dims → PartitionSpec tables are reused unchanged).

Mode `mh_test` is the self-check: process 0 spawns the other ranks
running the same command (the reference's self-spawning IPC test idiom,
cs_test_master rtc_ipc.cc:290-330), all ranks run the same sharded
fused-forward on a deterministic input, and rank 0 verifies every
rank's output digest matches its own. Reference analog for the command
surface: `rtc_ipc.cc` worker spawn via fork/exec-self.
"""

from __future__ import annotations

import os
import subprocess
import sys

from ..core.config import Attr
from ..core.error import RtErr
from ..core.has_main import HasMain, mode


def init_multihost(coordinator: str, num_processes: int,
                   process_id: int) -> None:
    """Join this process into the global jax.distributed runtime. Must
    run before anything initializes a jax backend."""
    import jax
    jax.distributed.initialize(coordinator, num_processes=num_processes,
                               process_id=process_id)


def host_array(sharding, global_np):
    """Build a (possibly non-addressable) global jax.Array from a
    host-replicated numpy array: every process passes the SAME global
    data; each fills only its addressable shards. device_put can't place
    onto other hosts' devices — this is the multi-host feed idiom."""
    import jax
    return jax.make_array_from_callback(
        global_np.shape, sharding, lambda idx: global_np[idx])


def force_local_cpu_devices(n: int) -> None:
    """Force JAX onto n virtual CPU devices (the multi-chip-without-a-
    cluster test rig). env alone is too late if jax.config was already
    imported (it snapshots JAX_PLATFORMS at import) — set both, before
    any backend initializes. Appends to XLA_FLAGS (doesn't clobber a
    user's dump/debug flags); strips any previous device-count flag."""
    flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
             if not f.startswith("--xla_force_host_platform_device_count")]
    flags.append(f"--xla_force_host_platform_device_count={n}")
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = " ".join(flags)
    import jax
    jax.config.update("jax_platforms", "cpu")


def free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("localhost", 0))
    p = s.getsockname()[1]
    s.close()
    return p


@mode("mh_test", help="CPU-only multi-process self-check: N "
                      "jax.distributed processes, each on virtual CPU "
                      "devices, run one sharded forward; rank 0 spawns "
                      "the others and verifies digests agree")
class MhTest(HasMain):
    coordinator = Attr(str, default="",
                       help="host:port of the jax.distributed "
                            "coordinator (default: pick a free local "
                            "port; rank 0 must be the coordinator host)")
    num_processes = Attr(int, default=2)
    process_id = Attr(int, default=0,
                      help="this process's rank (0 spawns 1..N-1)")
    spawn = Attr(bool, default=True,
                 help="rank 0 spawns the other ranks via exec-self "
                      "(cs_test_master idiom); 0 = every rank is "
                      "launched externally (real pods)")
    local_devices = Attr(int, default=0,
                         help="if >0: force JAX_PLATFORMS=cpu with this "
                              "many virtual devices per process (the "
                              "multi-node-without-a-cluster test rig); "
                              "0 = use the environment's real devices")
    model = Attr(str, default="mini")
    batch = Attr(int, default=0, help="0: 2 per global device")
    ysz = Attr(int, default=32)
    mp = Attr(int, default=1, help="model-parallel mesh width")
    train = Attr(bool, default=False,
                 help="run one sharded TRAINING step (softmax-CE + SGD, "
                      "grads psum'd across hosts by GSPMD) instead of a "
                      "forward; the digest covers the updated weights")

    def _apply_local_env(self) -> None:
        if self.local_devices:
            force_local_cpu_devices(self.local_devices)

    def _spawn_cmd(self, rank: int, coord: str) -> list:
        return [sys.executable, "-m", "boda_tpu", "mh_test",
                f"--coordinator={coord}",
                f"--num-processes={self.num_processes}",
                f"--process-id={rank}", "--spawn=0",
                f"--local-devices={self.local_devices}",
                f"--model={self.model}", f"--batch={self.batch}",
                f"--ysz={self.ysz}", f"--mp={self.mp}",
                f"--train={int(self.train)}"]

    def _digest_line(self) -> str:
        """Init distributed, run the sharded forward, return the digest
        line (printed by every rank)."""
        import numpy as np

        init_multihost(self.coordinator, self.num_processes,
                       self.process_id)
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..core.digest import nda_digest
        from ..parallel.mesh import make_mesh, plan_shardings
        devs = jax.devices()
        if len(devs) % self.mp:
            raise RtErr(f"mh_test: {len(devs)} devices not divisible "
                        f"by mp={self.mp}")
        mesh = make_mesh(mp=self.mp, devices=devs)
        import __graft_entry__ as ge
        batch = self.batch or 2 * len(devs)
        pipe, plan, fwd, weights = ge._fused_for(
            self.model, batch=batch, ysz=self.ysz, xsz=self.ysz)
        in_sh, w_sh = plan_shardings(plan, mesh)
        d = pipe.get_data_img_dims()
        x = np.random.RandomState(0).randn(*d.shape).astype(np.float32) * 0.1
        data_node = pipe.data_img_node_names[0]
        top = plan.output_nodes[-1]

        w_dev = {k: host_array(w_sh[k], v) for k, v in weights.items()}
        x_dev = host_array(in_sh[data_node], x)
        repl = NamedSharding(mesh, P())
        if self.train:
            from ..apps.train import build_train_step
            n_cls = plan.node_dims[top].shape[1]
            labels = np.random.RandomState(1).randint(
                0, n_cls, size=(batch,)).astype(np.int32)
            step = build_train_step(fwd, data_node, top, lr=0.01)
            # loss + one updated weight digested (replicated outputs);
            # the batch-sharded grads psum across HOSTS inside the jit
            wk = sorted(w_sh)[0]
            sharded = jax.jit(
                lambda w, xv, lb: step(w, {}, xv, lb)[:2],
                in_shardings=(w_sh, in_sh[data_node], repl),
                out_shardings=(repl, {k: repl for k in w_sh}))
            loss, new_w = sharded(w_dev, x_dev, host_array(repl, labels))
            out = np.asarray(new_w[wk])
            what = f"loss={float(loss):.6f} {wk}"
        else:
            sharded = jax.jit(
                lambda w, xv: fwd({data_node: xv}, w)[top],
                in_shardings=(w_sh, in_sh[data_node]),
                out_shardings=repl)
            out = np.asarray(sharded(w_dev, x_dev))
            what = top
        if not np.isfinite(out).all():
            raise RtErr("mh_test: non-finite output")
        return (f"mh_test rank {self.process_id}/{self.num_processes} "
                f"global_devices={len(devs)} {what} digest "
                f"{nda_digest(out)}")

    def main(self):
        if self.num_processes < 1:
            raise RtErr("mh_test: num_processes must be >= 1")
        if not (0 <= self.process_id < self.num_processes):
            raise RtErr(f"mh_test: process_id {self.process_id} out of "
                        f"range for num_processes={self.num_processes}")
        self._apply_local_env()
        import jax
        if self.process_id != 0 or not self.spawn:
            print(self._digest_line(), flush=True)
            # explicit disconnect: without it the non-daemon distributed
            # client threads keep the worker process alive after main()
            # and rank 0's communicate() never returns
            jax.distributed.shutdown()
            return
        if self.num_processes > 1 and not self.local_devices:
            # spawning N ranks that all open the same local real devices
            # wedges instead of erroring (one chip, serialized access);
            # real pods launch one externally-started rank per host
            raise RtErr("mh_test: spawn=1 with num_processes>1 needs "
                        "--local-devices=N (virtual CPU devices); for "
                        "real multi-host, launch one rank per host "
                        "externally with --spawn=0")
        import tempfile
        coord = self.coordinator or f"localhost:{free_port()}"
        self.coordinator = coord
        # children write to temp FILES, not pipes: a rank blocking on a
        # full pipe before its shutdown() barrier would deadlock rank 0
        logs = [tempfile.NamedTemporaryFile(
                    mode="w+", suffix=f".mh{r}.log", delete=False)
                for r in range(1, self.num_processes)]
        kids = [subprocess.Popen(self._spawn_cmd(r, coord),
                                 stdout=lg, stderr=subprocess.STDOUT,
                                 text=True, env=dict(os.environ))
                for r, lg in zip(range(1, self.num_processes), logs)]
        try:
            mine = self._digest_line()
        except BaseException:
            for k in kids:
                k.kill()
            raise
        print(mine, flush=True)
        # shutdown is a cross-rank barrier (coordination-service
        # Shutdown::*): rank 0 must join it BEFORE blocking on the
        # children, whose own shutdown() calls wait in the same barrier
        jax.distributed.shutdown()
        my_digest = mine.split("digest ", 1)[1]
        for r, (k, lg) in enumerate(zip(kids, logs), start=1):
            rc = k.wait(timeout=600)
            lg.seek(0)
            out = lg.read()
            lg.close()
            os.unlink(lg.name)
            if rc != 0:
                raise RtErr(f"mh_test: rank {r} failed "
                            f"(exit {rc}): {out.strip()[-300:]}")
            lines = [ln for ln in out.splitlines() if "digest " in ln]
            if not lines:
                raise RtErr(f"mh_test: rank {r} printed no digest")
            theirs = lines[-1].split("digest ", 1)[1]
            if theirs != my_digest:
                raise RtErr(f"mh_test: rank {r} digest differs:\n"
                            f"  rank0: {my_digest}\n  rank{r}: {theirs}")
        print(f"mh_test PASSED ranks={self.num_processes} "
              f"model={self.model}", flush=True)
