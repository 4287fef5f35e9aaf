"""Multi-process distribution for the trainer's scoring step.

The reference trainer is single-host shared-memory (Go goroutines +
channels, trainvocab.go:1826-2293).  Scaling past one process is a new
component: processes are connected with ``jax.distributed`` (gRPC
coordination), devices form a two-level mesh whose outer axis spans
processes and whose inner axis spans the devices of each process, and the
per-token score vectors are psum-reduced over BOTH axes.

Every process holds its own corpus shard (the process axis shards the text
exactly like the data axis does), so N-process scoring is bit-exact vs
single-host scoring on the concatenated corpus: integer psum is
associative and the strip layout is identical.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .score import _shard_score

HOST_AXIS = "hosts"
DATA_AXIS = "data"


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None):
    """Initialize the JAX distributed runtime (idempotent).

    With no arguments relies on the environment (cluster metadata or
    JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID); explicit
    arguments support manual multi-process launches (including CPU tests).
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)
    except RuntimeError as e:  # already initialized
        if "already" not in str(e).lower():
            raise


def make_multihost_mesh() -> Mesh:
    """(hosts, data) mesh: outer axis across processes, inner axis across
    each process's local devices."""
    n_proc = jax.process_count()
    local = jax.local_device_count()
    devices = np.asarray(jax.devices()).reshape(n_proc, local)
    return Mesh(devices, (HOST_AXIS, DATA_AXIS))


def make_multihost_score_step(mesh: Mesh, chunk: int, has_delete: bool,
                              delete_token: int, n_ids: int):
    """Mesh-sharded scoring step over (hosts, data).

    text is sharded over both axes (flattened shard per device); tables are
    replicated.  Outputs are psum'd over the local devices, then across
    processes — identical on every device of every process.
    """
    kernel = functools.partial(
        _shard_score, chunk=chunk, has_delete=has_delete,
        delete_token=delete_token, n_ids=n_ids)

    def step(text, dfa, dout, sdfa, sout, bb_byte, p1, i1, i2, ids3):
        scores, n_tok, n_miss = kernel(
            text, dfa, dout, sdfa, sout, bb_byte, p1, i1, i2, ids3)
        # local reduction first, then the combine of process partials
        axes = (DATA_AXIS, HOST_AXIS)
        return (jax.lax.psum(scores, axes),
                jax.lax.psum(n_tok, axes),
                jax.lax.psum(n_miss, axes))

    spec_data = P((HOST_AXIS, DATA_AXIS))
    spec_rep = P()
    sharded = jax.shard_map(
        step, mesh=mesh,
        in_specs=(spec_data,) + (spec_rep,) * 9,
        out_specs=(spec_rep, spec_rep, spec_rep),
        check_vma=False)
    return jax.jit(sharded)


def shard_text_for_process(text: np.ndarray, mesh: Mesh, chunk: int):
    """Build this process's slice of the globally-sharded corpus array.

    The global text is padded to devices*chunk-aligned strips and laid out
    so device d (in mesh order) owns strips [d*S, (d+1)*S).  Returns the
    jax.Array with the multihost sharding attached (addressable shards only).
    """
    n_dev = mesh.devices.size
    per = -(-len(text) // n_dev)
    per = -(-per // chunk) * chunk
    total = per * n_dev
    buf = np.zeros(total, np.uint8)
    buf[:len(text)] = text
    sharding = NamedSharding(mesh, P((HOST_AXIS, DATA_AXIS)))
    local_devs = [d for d in mesh.devices.reshape(-1)
                  if d.process_index == jax.process_index()]
    arrays = []
    for d in local_devs:
        i = list(mesh.devices.reshape(-1)).index(d)
        arrays.append(jax.device_put(buf[i * per:(i + 1) * per], d))
    return jax.make_array_from_single_device_arrays(
        (total,), sharding, arrays)
