"""Model save/load and training checkpoints (counterpart of
``paddle_tpu/io.py``; reference python/paddle/fluid/io.py save_vars,
save_persistables, save_inference_model).

Model files stay programs of save/load ops run on the executor. The
on-disk format is the JAX package's: ``__model__`` in the binary desc
codec, one tensor file per variable (or one container file), so a model
directory written by either package serves in the other.
``set_params_from_numpy`` carries parameters over as arrays.

Checkpoints (``save_checkpoint``, ``AsyncCheckpointer``,
``load_checkpoint``) keep the JAX package's layout:
``{dir}/checkpoint_{step}/{trainer_id}/`` holds one tensor file per
persistable, ``meta.json`` and ``train_state.json`` (the step, the
DataLoader cursor), and ``{dir}/checkpoint_{step}/_SUCCESS`` marks a
complete checkpoint. Each rank stages in ``checkpoint_{step}.tmp.{rank}``
and renames its directory into place; rank 0 marks the checkpoint once
every rank's directory is there, keeps the newest
``max_num_checkpoints`` and sweeps older unmarked and staging leftovers.
So checkpoints cross-load between the packages for the persistables, the
step and the data cursor.

Random state: the port writes its generators' states under
``torch_generators`` (device -> ``Generator.get_state()`` bytes) and
never ``rng_key``; a JAX ``rng_key`` it reads is not applied (the
streams differ, ROADMAP C "RNG"), which it logs once. A restore copies
into the scope's tensors in place and sets the scope's generators'
states, so a plan captured on that scope keeps its graphs.

With the monitor on a save reports the JAX package's ``checkpoint_*``
family (``checkpoint_save_seconds{path=sync|async}``,
``checkpoint_saves_total``, ``checkpoint_bytes``, ``checkpoint_stall_seconds``,
``checkpoint_join_seconds``, ``checkpoint_failures_total``,
``checkpoint_unmarked_total``), and a failed asynchronous save writes a
``ckpt_save_failure`` flight record; ``AsyncCheckpointer.stats`` holds
the last save's times and bytes either way.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from . import monitor as _monitor
from .core import binary
from .core.desc import OpDesc, ProgramDesc
from .core.types import DataType, VarType, dtype_to_numpy, dtype_to_torch
from .framework import Parameter, Program, Variable, default_main_program
from .testing import faults as _faults
from .utils.flags import FLAGS

__all__ = ["save_vars", "save_params", "save_persistables", "load_vars",
           "load_params", "load_persistables", "save_inference_model",
           "load_inference_model", "set_params_from_numpy",
           "save_checkpoint", "load_checkpoint", "clean_checkpoint",
           "capture_train_state", "read_train_state", "AsyncCheckpointer"]

_log = logging.getLogger(__name__)


def _is_persistable(var: Variable) -> bool:
    return var.persistable


def _program_of(main_program) -> Program:
    """The Program of ``main_program`` (a CompiledProgram's own)."""
    main_program = main_program or default_main_program()
    return getattr(main_program, "_program", main_program)


def _io_program(main_program, vars, predicate):
    main_program = _program_of(main_program)
    if vars is None:
        vars = [v for v in main_program.list_vars()
                if (predicate or _is_persistable)(v)]
    prog = Program()
    blk = prog.global_block()
    names = []
    for v in vars:
        if v.desc.type != VarType.DENSE_TENSOR:
            continue
        blk.create_var(name=v.name, dtype=v.dtype, shape=v.shape,
                       persistable=True)
        names.append(v.name)
    return prog, blk, names


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None, scope=None):
    """Build a program of save ops and run it (on ``scope``, the global
    scope by default)."""
    prog, blk, names = _io_program(main_program, vars, predicate)
    if filename is None:
        for n in names:
            blk.append_op(type="save", inputs={"X": [n]}, outputs={},
                          attrs={"file_path": os.path.join(dirname, n)})
    else:
        blk.append_op(type="save_combine", inputs={"X": names}, outputs={},
                      attrs={"file_path": os.path.join(dirname, filename)})
    executor.run(prog, scope=scope)


def _is_parameter(var: Variable) -> bool:
    return isinstance(var, Parameter)


def save_params(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program,
                     predicate=_is_parameter, filename=filename)


def save_persistables(executor, dirname, main_program=None, filename=None,
                      scope=None):
    return save_vars(executor, dirname, main_program,
                     predicate=_is_persistable, filename=filename,
                     scope=scope)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    prog, blk, names = _io_program(main_program, vars, predicate)
    if filename is None:
        for n in names:
            blk.append_op(type="load", inputs={}, outputs={"Out": [n]},
                          attrs={"file_path": os.path.join(dirname, n)})
    else:
        blk.append_op(type="load_combine", inputs={}, outputs={"Out": names},
                      attrs={"file_path": os.path.join(dirname, filename)})
    executor.run(prog)


def load_params(executor, dirname, main_program=None, filename=None):
    return load_vars(executor, dirname, main_program,
                     predicate=_is_parameter, filename=filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    return load_vars(executor, dirname, main_program,
                     predicate=_is_persistable, filename=filename)


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None):
    """Prune to the feed -> fetch slice, write the program with feed and
    fetch marker ops (each feed op is prepended, so the saved feed order
    is the reverse of ``feeded_var_names``, as in the JAX package), and
    save the persistables it reads."""
    main_program = main_program or default_main_program()
    os.makedirs(dirname, exist_ok=True)
    target_names = [v.name if isinstance(v, Variable) else v
                    for v in target_vars]
    pruned = main_program._prune(feeded_var_names, target_names)
    blk = pruned.desc.blocks[0]
    for i, name in enumerate(feeded_var_names):
        blk.prepend_op(OpDesc("feed", {}, {"Out": [name]}, {"col": i}))
    for i, name in enumerate(target_names):
        blk.append_op(OpDesc("fetch", {"X": [name]}, {}, {"col": i}))
    with open(os.path.join(dirname, model_filename or "__model__"),
              "wb") as f:
        f.write(pruned.desc.to_bytes())
    blk.ops = [op for op in blk.ops if op.type not in ("feed", "fetch")]
    save_persistables(executor, dirname, pruned, filename=params_filename)
    return target_names


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    """(program, feed_names, fetch_vars) of a saved inference model, its
    persistables loaded into the executor's scope on its device."""
    with open(os.path.join(dirname, model_filename or "__model__"),
              "rb") as f:
        raw = f.read()
    if not binary.is_binary_program(raw):
        raise ValueError(f"{dirname}: __model__ is not a binary ProgramDesc")
    desc = ProgramDesc.from_bytes(raw)
    blk0 = desc.blocks[0]
    feed_names = [op.output("Out")[0] for op in blk0.ops if op.type == "feed"]
    fetch_names = [op.input("X")[0] for op in blk0.ops if op.type == "fetch"]
    blk0.ops = [op for op in blk0.ops if op.type not in ("feed", "fetch")]
    program = Program._from_desc(desc)
    load_persistables(executor, dirname, program, filename=params_filename)
    fetch_vars = [program.global_block().var(n) for n in fetch_names]
    return program, feed_names, fetch_vars


def set_params_from_numpy(scope, arrays: Dict[str, np.ndarray], device,
                          program: Optional[Program] = None):
    """Place ``arrays`` (name -> ndarray, e.g. the JAX package's trained
    or initialized parameters) into ``scope`` as tensors on ``device``.
    The names must be exactly the program's persistable variables, each
    with the shape and dtype the program declares; an int64 variable
    (``auc``'s stat buckets, a step counter) also takes the int32 array
    the JAX package holds it in (x64 off), widened."""
    program = program or default_main_program()
    want = {v.name: v for v in program.list_vars() if v.persistable}
    missing = sorted(set(want) - set(arrays))
    extra = sorted(set(arrays) - set(want))
    if missing or extra:
        raise KeyError(f"set_params_from_numpy: missing {missing}, not in "
                       f"the program {extra}")
    device = torch.device(device)
    for name, arr in arrays.items():
        var = want[name]
        arr = np.asarray(arr)
        if list(arr.shape) != list(var.shape):
            raise ValueError(f"set_params_from_numpy: {name} has shape "
                             f"{list(arr.shape)}, the program declares "
                             f"{list(var.shape)}")
        if var.dtype == DataType.INT64 and arr.dtype == np.int32:
            arr = arr.astype(np.int64)
        if var.dtype == DataType.BF16 or arr.dtype != dtype_to_numpy(
                var.dtype):
            raise TypeError(f"set_params_from_numpy: {name} is "
                            f"{arr.dtype}, the program declares "
                            f"{var.dtype.name}")
        scope.set_var(name, torch.tensor(arr, device=device))


# ---------------------------------------------------------------------------
# training checkpoints
# ---------------------------------------------------------------------------

_CKPT_PREFIX = "checkpoint_"
_SUCCESS = "_SUCCESS"
_TRAIN_STATE = "train_state.json"
_TRAIN_STATE_VERSION = 1
_rng_key_noted = []


def _checkpoint_vars(main_program):
    return [v for v in _program_of(main_program).list_vars()
            if _is_persistable(v) and v.desc.type == VarType.DENSE_TENSOR]


def capture_train_state(step, scope=None, loader=None, extra=None):
    """The non-tensor state of a run at ``step``: the step, the scope's
    generators' states (``torch_generators``: device -> state bytes as
    hex) and, given a loader, its cursor (``data_cursor``). The versioned
    payload ``save_checkpoint`` and ``AsyncCheckpointer.save`` write as
    train_state.json. Call it between steps: a generator's state is read
    on the host, where a step's draws are accounted when it is
    enqueued."""
    from .executor import global_scope

    scope = scope or global_scope()
    state = {"version": _TRAIN_STATE_VERSION, "step": int(step)}
    gens = {dev: bytes(g.get_state().cpu().numpy()).hex()
            for dev, g in sorted(scope._generators.items())}
    if gens:
        state["torch_generators"] = gens
    if loader is not None and hasattr(loader, "state_dict"):
        state["data_cursor"] = loader.state_dict()
    if extra:
        state["extra"] = dict(extra)
    return state


def _restore_generators(state, scope):
    """Set the scope's generators to the payload's states; a JAX
    ``rng_key`` is not applied (logged once)."""
    if state.get("rng_key") is not None and not _rng_key_noted:
        _rng_key_noted.append(True)
        _log.warning(
            "checkpoint train_state holds a JAX rng_key: not applied, "
            "since the port's generators cannot continue a Threefry key "
            "stream; random ops draw from the scope's own generator")
    for dev, hexed in (state.get("torch_generators") or {}).items():
        device = torch.device(dev)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"checkpoint holds a generator state of "
                               f"{dev}, and there is no CUDA device")
        gen = scope.generator(device, 0)
        gen.set_state(torch.tensor(list(bytes.fromhex(hexed)),
                                   dtype=torch.uint8))


def _write_train_state(rank_tmp, state):
    if state is None:
        return
    with open(os.path.join(rank_tmp, _TRAIN_STATE), "w") as f:
        json.dump(state, f)


def _read_train_state_dir(rankdir):
    """The train_state payload of one rank directory, or None (a
    checkpoint without one still restores its tensors)."""
    path = os.path.join(rankdir, _TRAIN_STATE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        state = json.load(f)
    if int(state.get("version", 0)) > _TRAIN_STATE_VERSION:
        raise ValueError(
            f"train_state.json version {state.get('version')} is newer "
            f"than this build understands ({_TRAIN_STATE_VERSION})")
    return state


def _ckpt_step_dirs(checkpoint_dir):
    out = []
    if not os.path.isdir(checkpoint_dir):
        return out
    for name in os.listdir(checkpoint_dir):
        if name.startswith(_CKPT_PREFIX) and ".tmp" not in name:
            try:
                out.append((int(name[len(_CKPT_PREFIX):]), name))
            except ValueError:
                continue
    return sorted(out)


def read_train_state(checkpoint_dir, step=None, trainer_id=0):
    """The train_state payload of the newest complete checkpoint (or of
    ``step``), without reading tensors; None when there is none."""
    for s, name in reversed(_ckpt_step_dirs(checkpoint_dir)):
        if step is not None and s != step:
            continue
        d = os.path.join(checkpoint_dir, name)
        if not os.path.exists(os.path.join(d, _SUCCESS)):
            continue
        return _read_train_state_dir(os.path.join(d, str(trainer_id)))
    return None


def _stage_paths(checkpoint_dir, step, trainer_id):
    """{dir}/checkpoint_{step}.tmp.{rank}/{rank}, renamed into
    {dir}/checkpoint_{step}/{rank}."""
    final = os.path.join(checkpoint_dir, f"{_CKPT_PREFIX}{step}")
    tmp = f"{final}.tmp.{trainer_id}"
    return final, tmp, os.path.join(tmp, str(trainer_id))


def _write_meta(rank_tmp, step, trainer_id):
    with open(os.path.join(rank_tmp, "meta.json"), "w") as f:
        json.dump({"step": int(step), "time": time.time(),
                   "trainer_id": trainer_id}, f)


def _publish_rank_dir(final, tmp, rank_tmp, trainer_id):
    os.makedirs(final, exist_ok=True)
    rank_final = os.path.join(final, str(trainer_id))
    if os.path.isdir(rank_final):
        shutil.rmtree(rank_final)
    os.rename(rank_tmp, rank_final)
    shutil.rmtree(tmp, ignore_errors=True)


def _mark_and_retain(checkpoint_dir, final, step, trainer_id,
                     num_trainers, max_num_checkpoints, rank_wait_s=None):
    """Rank 0: mark the checkpoint once every rank's directory is in
    (else raise and leave it unmarked), keep the newest
    ``max_num_checkpoints`` marked ones, and sweep unmarked and staging
    directories older than the newest marked one."""
    if trainer_id != 0:
        return
    wait_s = float(FLAGS.ckpt_rank_wait_s if rank_wait_s is None
                   else rank_wait_s)
    deadline = time.time() + wait_s
    while not all(os.path.isdir(os.path.join(final, str(r)))
                  for r in range(num_trainers)):
        if time.time() >= deadline:
            if _monitor._enabled:
                # seen even when a supervisor's retry swallows the raise
                _monitor.counter("checkpoint_unmarked_total").inc()
            raise RuntimeError(
                f"checkpoint step {step}: not all {num_trainers} rank dirs "
                f"appeared within {wait_s:g}s (FLAGS.ckpt_rank_wait_s); "
                "leaving it UNMARKED (restore will use the previous "
                "complete checkpoint)")
        time.sleep(0.2)
    with open(os.path.join(final, _SUCCESS), "w") as f:
        f.write(str(int(step)))
    all_dirs = _ckpt_step_dirs(checkpoint_dir)
    marked = [(s, n) for s, n in all_dirs if os.path.exists(
        os.path.join(checkpoint_dir, n, _SUCCESS))]
    for s, n in marked[:-max_num_checkpoints]:
        shutil.rmtree(os.path.join(checkpoint_dir, n), ignore_errors=True)
    newest_marked = marked[-1][0] if marked else -1
    for s, n in all_dirs:
        if s < newest_marked and not os.path.exists(
                os.path.join(checkpoint_dir, n, _SUCCESS)):
            shutil.rmtree(os.path.join(checkpoint_dir, n), ignore_errors=True)
    for name in os.listdir(checkpoint_dir):
        if ".tmp" in name and name.startswith(_CKPT_PREFIX):
            try:
                stale = int(name[len(_CKPT_PREFIX):].split(".")[0])
            except ValueError:
                continue
            if stale < newest_marked:
                shutil.rmtree(os.path.join(checkpoint_dir, name),
                              ignore_errors=True)


def _note_saved(path_label, wall_s, nbytes, step):
    if not _monitor._enabled:
        return
    _monitor.timer("checkpoint_save_seconds",
                   {"path": path_label}).observe(wall_s)
    _monitor.gauge("checkpoint_bytes").set(int(nbytes))
    _monitor.counter("checkpoint_bytes_total").inc(int(nbytes))
    _monitor.gauge("checkpoint_last_step").set(int(step))
    _monitor.counter("checkpoint_saves_total",
                     {"path": path_label}).inc()


def _dir_bytes(d) -> int:
    total = 0
    for root, _dirs, files in os.walk(d):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(root, f))
            except OSError:
                continue
    return total


def save_checkpoint(executor, checkpoint_dir, step, main_program=None,
                    trainer_id=0, num_trainers=1, max_num_checkpoints=3,
                    train_state=None, rank_wait_s=None, scope=None):
    """A step-numbered checkpoint of every persistable, written through a
    program of ``save`` ops (each waits for its tensor's copy to the
    host), staged and published as the module docstring says.
    ``train_state`` defaults to ``capture_train_state(step, scope)``.
    Returns the checkpoint's directory."""
    t0 = time.perf_counter()
    final, tmp, rank_tmp = _stage_paths(checkpoint_dir, step, trainer_id)
    os.makedirs(rank_tmp, exist_ok=True)
    save_persistables(executor, rank_tmp, main_program, scope=scope)
    _write_meta(rank_tmp, step, trainer_id)
    if train_state is None:
        train_state = capture_train_state(step, scope=scope)
    _write_train_state(rank_tmp, train_state)
    # with the staging directory written but neither published nor
    # marked: what a kill in the middle of a save leaves
    _faults.fire("ckpt_write")
    _publish_rank_dir(final, tmp, rank_tmp, trainer_id)
    _mark_and_retain(checkpoint_dir, final, step, trainer_id, num_trainers,
                     max_num_checkpoints, rank_wait_s)
    if _monitor._enabled:
        _note_saved("sync", time.perf_counter() - t0,
                    _dir_bytes(os.path.join(final, str(trainer_id))), step)
    return final


def _restore_persistables(executor, rankdir, main_program, scope):
    """Each persistable's file into the scope: copied into the scope's
    tensor when it has the file's shape (cast to its dtype, so a plan
    captured on the scope keeps its graphs), else bound on the
    executor's device in the program's declared dtype (a JAX-written
    int32 file of an int64 variable becomes int64)."""
    from .ops.kernels_host import load_tensor_from_file

    for v in _checkpoint_vars(main_program):
        t = load_tensor_from_file(os.path.join(rankdir, v.name))
        cur = scope.find_var(v.name)
        if isinstance(cur, torch.Tensor) and cur.shape == t.shape:
            cur.copy_(t)
            continue
        want = dtype_to_torch(v.dtype) if v.dtype is not None else t.dtype
        scope.set_var(v.name, t.to(device=executor.device, dtype=want))


def load_checkpoint(executor, checkpoint_dir, main_program=None,
                    trainer_id=0, scope=None):
    """Restore the newest complete checkpoint (an unmarked one, from a
    save that was cut, is skipped): the persistables in place, then the
    generators' states of its train_state.json. Returns its step, or
    None when there is none. The DataLoader cursor is the caller's to
    apply (``read_train_state``, ``ElasticTrainer.restore``)."""
    from .executor import global_scope

    scope = scope or global_scope()
    for step, name in reversed(_ckpt_step_dirs(checkpoint_dir)):
        d = os.path.join(checkpoint_dir, name)
        if not os.path.exists(os.path.join(d, _SUCCESS)):
            continue
        rankdir = os.path.join(d, str(trainer_id))
        _restore_persistables(executor, rankdir, main_program, scope)
        state = _read_train_state_dir(rankdir)
        if state is not None:
            _restore_generators(state, scope)
        return step
    return None


def clean_checkpoint(checkpoint_dir, delete_dir=False):
    if os.path.isdir(checkpoint_dir):
        for name in os.listdir(checkpoint_dir):
            if name.startswith(_CKPT_PREFIX):  # staging dirs too
                shutil.rmtree(os.path.join(checkpoint_dir, name),
                              ignore_errors=True)
    if delete_dir and os.path.isdir(checkpoint_dir):
        shutil.rmtree(checkpoint_dir, ignore_errors=True)


class AsyncCheckpointer:
    """Checkpoints written on a thread, so the step loop pays only the
    snapshot: ``save()`` clones every persistable on the device, on the
    caller's current stream, and returns. The clones are ordered after
    the step that made the values and before the next step, which
    updates the scope's tensors in place (a captured replay does too);
    they cost one copy of the persistables in device memory until the
    writer has them on the host. The writer waits for an event recorded
    after the clones, copies each to the host, writes the files, and
    publishes and marks the checkpoint as ``save_checkpoint`` does (the
    same layout, so ``load_checkpoint`` reads either).

    At most one save is in flight: ``save()``, ``wait()`` and ``close()``
    join the previous one first, and a writer's error is raised at the
    next of them, so a failed checkpoint is never passed over. An
    ``atexit`` hook joins the last writer. ``stats`` holds the last
    save's ``stall_s`` (the snapshot the caller paid), ``join_s`` (its
    wait for the previous writer), ``write_s`` (the writer's wall time)
    and ``bytes``, and the count of ``saves``."""

    def __init__(self):
        import atexit

        self._thread = None
        self._error = None
        self.stats = {"saves": 0, "stall_s": 0.0, "join_s": 0.0,
                      "write_s": 0.0, "bytes": 0}
        atexit.register(self._atexit_join)

    def save(self, executor, checkpoint_dir, step, main_program=None,
             trainer_id=0, num_trainers=1, max_num_checkpoints=3,
             scope=None, train_state=None, rank_wait_s=None,
             on_success=None):
        """Snapshot and start the writer; ``on_success()`` runs on the
        writer once the checkpoint is published and marked. Returns the
        checkpoint's directory."""
        from .executor import global_scope, snapshot_value

        j0 = time.perf_counter()
        self.wait()
        t0 = time.perf_counter()
        if _monitor._enabled and t0 - j0 > 1e-4:
            # a real join of the previous save (a stall of its own)
            _monitor.timer("checkpoint_join_seconds").observe(t0 - j0)
        scope = scope or global_scope()
        snap = {}
        for v in _checkpoint_vars(main_program):
            val = scope.find_var(v.name)
            if val is not None:
                snap[v.name] = snapshot_value(val).device_value()
        if train_state is None:
            train_state = capture_train_state(step, scope=scope)
        copied = None
        if any(t.is_cuda for t in snap.values()):
            copied = torch.cuda.Event()
            copied.record()
        final, tmp, rank_tmp = _stage_paths(checkpoint_dir, step, trainer_id)
        stats = self.stats

        def write():
            from .ops.kernels_host import save_tensor_to_file

            w0 = time.perf_counter()
            try:
                if copied is not None:
                    copied.synchronize()
                os.makedirs(rank_tmp, exist_ok=True)
                nbytes = 0
                for name in list(snap):
                    t = snap.pop(name)  # its device copy goes once written
                    save_tensor_to_file(os.path.join(rank_tmp, name), t)
                    nbytes += t.numel() * t.element_size()
                _write_meta(rank_tmp, step, trainer_id)
                _write_train_state(rank_tmp, train_state)
                _faults.fire("ckpt_write")
                _publish_rank_dir(final, tmp, rank_tmp, trainer_id)
                _mark_and_retain(checkpoint_dir, final, step, trainer_id,
                                 num_trainers, max_num_checkpoints,
                                 rank_wait_s)
                stats["write_s"] = time.perf_counter() - w0
                stats["bytes"] = nbytes
                _note_saved("async", stats["write_s"], nbytes, step)
                if on_success is not None:
                    on_success()
            except BaseException as e:  # raised at the next save or wait
                self._error = e
                if _monitor._enabled:
                    _monitor.counter("checkpoint_failures_total").inc()
                _monitor.flight_record(
                    "ckpt_save_failure",
                    extra={"step": int(step), "dir": checkpoint_dir,
                           "error": repr(e)})

        self._thread = threading.Thread(target=write, daemon=True,
                                        name=f"async-ckpt-{step}")
        self._thread.start()
        stats["saves"] += 1
        stats["join_s"] = t0 - j0
        stats["stall_s"] = time.perf_counter() - t0
        if _monitor._enabled:
            # what the step loop paid: the snapshot and the enqueue
            _monitor.timer("checkpoint_stall_seconds").observe(
                stats["stall_s"])
        return final

    def wait(self):
        """Join the save in flight; raise its writer's error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from err

    def _atexit_join(self):
        """At interpreter exit: join the writer (a daemon thread, which
        exit would cut) and warn of its error rather than raise."""
        import warnings

        t = self._thread
        if t is not None and t.is_alive():
            t.join()
        if self._error is not None:
            warnings.warn("async checkpoint write failed at interpreter "
                          f"exit: {self._error!r}")

    def close(self):
        """``wait()`` and unregister the atexit hook."""
        import atexit

        try:
            self.wait()
        finally:
            atexit.unregister(self._atexit_join)
