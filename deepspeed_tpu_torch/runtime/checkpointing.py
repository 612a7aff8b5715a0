"""Checkpoint save/load (counterpart of ``deepspeed_tpu/runtime/checkpointing.py``).

A tag keeps the JAX package's layout — ``<tag>/state/``, ``<tag>/meta.json``
and ``<tag>/manifest.json``, staged in ``<tag>.tmp/``, with ``latest``
beside the tags — but ``state/`` is one ``torch.save`` file
(``state/state.pt``): a flat dict from name to CPU tensor, loaded with
``torch.load(weights_only=True)``, pickling nothing but tensors and plain
containers.  The names are the JAX portable state's top-level keys
(``params``, ``opt_state``, ``loss_scale``, ``micro_step``,
``global_step``, ``global_samples``; ``grad_acc`` when a save falls
between micro-steps) joined by ``/`` to each leaf's path
(``params/blocks/qkv_w``, ``opt_state/exp_avg/wte``).  Masters and moments
are f32 on disk.  A JAX (orbax) tag cannot be read here, nor a port tag by
JAX: the interchange point is :func:`consolidate_fp32_state_dict`, whose
names and values equal the JAX package's.

Durability (``deepspeed_tpu_torch.resilience``): a tag is written into
``<tag>.tmp``, a size+checksum ``manifest.json`` goes in last, and a
single rename publishes it — a kill at any point leaves the previous
tree intact.  On load the manifest is re-verified; a corrupt tag is
quarantined (``<tag>.corrupt``) and the load falls back to the newest
verified tag.  Checkpoint I/O runs under the configured retry policy,
and retention GC (``keep_last_n``/``keep_every``) runs after each
successful save.  The fault sites ``ckpt.save.state``, ``ckpt.save.meta``
(here), ``ckpt.commit`` and ``ckpt.latest`` (``resilience/manager.py``)
sit where the JAX package has them.

Across ranks (a ZeRO engine on a process group), the tag keeps the same
single ``state.pt``: every tensor is gathered to its whole, natural shape
(flat-padded leaves unpadded), so a tag does not depend on the world size
or the stage that wrote it — it loads at any world size, and one-process
tags load across ranks and back.  Every rank takes part in the gathers;
rank 0 owns the staging directory and the commit, between barriers, as
in the JAX package (``deepspeed_tpu/runtime/checkpointing.py:228-316``).
A failed write is not retried on one rank alone (the save is collective),
an async save falls back to a synchronous one with the JAX package's
warning, and on load rank 0 picks the tag (its scan, verification and
quarantine) and broadcasts it.  Each rank then reads the file and keeps
its own slices.

Under ZeRO-Offload (``runtime/zero/offload.py``; both offload engines)
the tag's ``params/<path>`` are the host f32 masters and the moments go
in as ``host_optimizer/m/<path>`` and ``host_optimizer/v/<path>`` (under
``nvme`` read back from disk first), in the same ``state.pt`` under the
same commit protocol.  A tag without them (saved without offload) loads
into an offload engine as the JAX package's ``load_masters`` path does:
the masters from the tag's parameters, the moments reset, with its
warning.  An offload tag does not load into an engine without offload
(its ``opt_state`` is missing).

Across ranks an offload engine's host state goes in per-rank files beside
``state.pt`` (``_rank_files``), written into the staging directory by
every rank before rank 0's manifest: the in-memory engine's flat slices as
``host_optimizer_shard<i>.pt`` (a restore under another slice count
rebuilds the masters from ``params/`` and resets the moments, with the JAX
package's warning), the streaming engine's fsdp parts as
``host_optimizer_rank<r>.pt`` (restored at any fsdp size).  The 1-bit
optimizers' compressed phase follows the tag's step count before a restore
(``_sync_onebit_phase``); its residuals, and the onebit strategy's
(``comm/``), are gathered to ``(n, Mp)`` rows, each rank restoring its own.

Not ported, each with its ROADMAP item: the supervision plane's
``local_npz`` emergency format and its armed barriers (A14); the
sanitizer's donation, transfer and drift hooks (A15).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.resilience import CheckpointNotFoundError, atomic, faults, manager
from deepspeed_tpu_torch.resilience.policy import retry_call
from deepspeed_tpu_torch.utils.logging import log_dist, logger

LATEST_FILE = manager.LATEST_FILE
STATE_DIR = "state"
STATE_FILE = "state.pt"  # one name in every tag: torch.save names its records after it


def _ckpt_path(save_dir: str, tag: str) -> str:
    return os.path.join(os.path.abspath(save_dir), str(tag))


def _path_str(path) -> str:
    """A leaf's path as the JAX package writes it (a copy of
    ``deepspeed_tpu/runtime/zero/stages.py::_path_str``): dict keys,
    sequence indices and field names joined by ``/``."""
    return "/".join(str(p) for p in path)


def _walk(tree: Any, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """``(path, leaf)`` of a tree of dicts (sorted keys), lists, tuples and
    dataclasses (field order: the NamedTuple states of the JAX package)."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _walk(tree[key], path + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _walk(x, path + (i,))
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _walk(getattr(tree, f.name), path + (f.name,))
    else:
        yield path, tree


def _opt_fields(engine) -> Dict[str, Any]:
    """The optimizer state by field (``AdamState`` / ``LambState`` / SGD's
    dict)."""
    opt = engine.opt_state
    if dataclasses.is_dataclass(opt):
        return {f.name: getattr(opt, f.name) for f in dataclasses.fields(opt)}
    return dict(opt)


def _per_leaf(engine, x) -> bool:
    return isinstance(x, list) and len(x) == len(engine._params)


HOST_OPT = "host_optimizer"


def _sharded_offload(engine) -> bool:
    """Whether an offload engine's masters are cut into flat slices (the
    in-memory engine across ranks or under ``DS_OFFLOAD_SHARDS``)."""
    return getattr(engine, "_offload_shards", 1) > 1


def _offload_state_tensors(engine) -> Dict[str, torch.Tensor]:
    """An offload engine's tensors by name: the host masters as
    ``params/``, the host moments under ``host_optimizer/`` (one slice
    layout only: sliced masters and moments go in per-shard files,
    :func:`_rank_files`), the loss scaler's state and the pending
    gradients (live tensors)."""
    out = {}
    if getattr(engine, "_masters_sharded", False):
        # the streaming engine across fsdp: masters and moments go in each
        # rank's own file (:func:`_rank_files`)
        for path, leaf in _walk(engine.loss_scale_state, ("loss_scale",)):
            out[_path_str(path)] = leaf
        return out
    # under a model or expert axis each rank holds its block of a cut
    # leaf: the tag keeps the natural layout (gathered, collective)
    nat = getattr(engine, "_host_natural", lambda i, t: t)
    if _sharded_offload(engine):
        for i, (k, m) in enumerate(zip(engine._paths, engine._masters_full)):
            out[f"params/{k}"] = nat(i, m)
        keys, masters = engine._paths, engine._masters_full
    else:
        sd = engine._host_opt.state_dict()
        for i, k in enumerate(engine._host_opt.keys):
            out[f"params/{k}"] = nat(i, sd[f"master/{k}"])
            out[f"{HOST_OPT}/m/{k}"] = nat(i, sd[f"m/{k}"])
            out[f"{HOST_OPT}/v/{k}"] = nat(i, sd[f"v/{k}"])
        keys, masters = engine._host_opt.keys, engine._host_opt.masters
    for path, leaf in _walk(engine.loss_scale_state, ("loss_scale",)):
        out[_path_str(path)] = leaf
    acc = getattr(engine, "_grad_acc", None) or []
    if any(a is not None for a in acc):
        for i, (k, a, m) in enumerate(zip(keys, acc, masters)):
            out[f"grad_acc/{k}"] = nat(i, a if a is not None else torch.zeros_like(m))
    return out


def _shard_file(i: int) -> str:
    return f"host_optimizer_shard{i}.pt"


def _rank_files(engine) -> Dict[str, Dict[str, torch.Tensor]]:
    """The files this rank writes beside ``state.pt`` (host copies): a
    sliced offload engine's ``host_optimizer_shard<i>.pt`` for each slice it
    steps (``master/flat``, ``m/flat``, ``v/flat``), the streaming
    engine's per-rank file across ``fsdp``."""
    if _sharded_offload(engine):
        return {_shard_file(i): {k: t.detach().clone() for k, t in opt.state_dict().items()}
                for i, opt in zip(engine._host_shard_ids, engine._host_opts)}
    files = getattr(engine, "_rank_files", None)
    return {} if files is None else files()


def _state_tensors(engine) -> Dict[str, torch.Tensor]:
    """The tag's tensors by name, whole: the f32 masters, the optimizer
    state (a list of per-parameter tensors is named by the parameters'
    paths, as the JAX state's parameter-shaped subtrees are), the loss
    scaler's state and, between micro-steps, the pending gradients.  Where
    ZeRO cuts a leaf this gathers it (every rank must call); otherwise the
    names map to the engine's live tensors."""
    if getattr(engine, "_host_opt", None) is not None:
        return _offload_state_tensors(engine)
    layout = engine.layout
    nat = lambda i, t, spec: layout.natural(i, t.detach(), spec) if t.dim() else t  # noqa: E731
    params = [nat(i, p, layout.leaves[i].param_spec) for i, p in enumerate(engine._params)]
    opt = {}
    fields = (engine._portable_opt_fields() if hasattr(engine, "_portable_opt_fields")
              else _opt_fields(engine))
    for name, x in fields.items():
        # the 8-bit state's block scales are whole on every rank
        opt[name] = (engine._unflatten([t if name == "vs" else nat(i, t, layout.leaves[i].opt_spec)
                                        for i, t in enumerate(x)])
                     if _per_leaf(engine, x) else x)
    tree = {"params": engine._unflatten(params), "opt_state": opt,
            "loss_scale": engine.loss_scale_state}
    if any(a is not None for a in engine._grad_acc):
        tree["grad_acc"] = engine._unflatten([
            nat(i, a, layout.leaves[i].acc_spec) if a is not None else torch.zeros_like(params[i])
            for i, a in enumerate(engine._grad_acc)])
    out = {_path_str(path): leaf for path, leaf in _walk(tree)}
    if hasattr(engine, "_comm_state"):
        out.update(engine._comm_state())
    return out


def _snapshot_state_to_host(engine) -> Dict[str, torch.Tensor]:
    """Every tensor of the tag copied to the host, plus the step counters.
    On the card the copies go into pinned host tensors on a side stream
    that waits for the work queued so far, and their event is
    synchronized before this returns: the fused optimizer kernels update
    masters and moments in place, so after this training may overwrite
    the device tensors freely."""
    live = _state_tensors(engine)
    counters = {name: torch.tensor(value, dtype=torch.int32) for name, value in (
        ("micro_step", engine._host_micro_step), ("global_step", engine._host_global_step),
        ("global_samples", engine.global_samples))}
    if engine.device.type != "cuda":
        return {**{n: t.detach().to("cpu", copy=True) for n, t in live.items()}, **counters}
    stream = torch.cuda.Stream(engine.device)
    stream.wait_stream(torch.cuda.current_stream(engine.device))
    out = {}
    with torch.cuda.stream(stream):
        for name, t in live.items():
            if t.device.type == "cpu":  # an offload engine's host state
                out[name] = t.detach().clone()
                continue
            out[name] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            out[name].copy_(t.detach(), non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    done.synchronize()
    return {**out, **counters}


def _write_state(target: str, snapshot: Dict[str, torch.Tensor], files=None) -> None:
    """``state.pt`` and, when given, this rank's files beside it."""
    os.makedirs(os.path.join(target, STATE_DIR), exist_ok=True)
    if snapshot is not None:
        torch.save(snapshot, os.path.join(target, STATE_DIR, STATE_FILE))
    for name, tensors in (files or {}).items():
        torch.save(tensors, os.path.join(target, STATE_DIR, name))


def _resilience_cfg(engine):
    cfg = getattr(getattr(engine, "config", None), "resilience", None)
    if cfg is None:
        from deepspeed_tpu_torch.config.config import ResilienceConfig

        cfg = ResilienceConfig()
    return cfg


def _note_ckpt_dir(engine, directory: str) -> None:
    note = getattr(engine, "_note_checkpoint_dir", None)
    if note is not None:
        note(directory)


def _loader_state(engine) -> Optional[dict]:
    """The registered dataloader's resume cursor, or None (loaders
    without the state protocol never break a save)."""
    loader = getattr(engine, "_train_loader", None)
    if loader is None or not hasattr(loader, "state_dict"):
        return None
    try:
        return loader.state_dict()
    except Exception as e:  # noqa: BLE001 — cursors are best-effort
        logger.warning(f"dataloader state_dict failed ({e!r}); checkpoint has no resume cursor")
        return None


def _merge_loader_state(engine, client_state: Optional[dict]) -> Optional[dict]:
    """Fold the registered loader's cursor into the client state (an
    explicit caller-provided '__dataloader__' wins)."""
    sd = _loader_state(engine)
    if sd is None:
        return client_state
    out = dict(client_state or {})
    out.setdefault("__dataloader__", sd)
    return out


def _restore_loader_state(engine, client_state: Dict[str, Any]) -> None:
    sd = client_state.get("__dataloader__")
    loader = getattr(engine, "_train_loader", None)
    if not sd or loader is None or not hasattr(loader, "load_state_dict"):
        return
    try:
        loader.load_state_dict(sd)
        log_dist(
            f"dataloader cursor restored (epoch {sd.get('epoch')}, batch {sd.get('cursor')})"
        )
    except Exception as e:  # noqa: BLE001
        logger.warning(f"dataloader cursor restore failed ({e!r}); loader starts fresh")


def _world(engine) -> int:
    """The ranks a save or load spans (1: no collective, no barrier)."""
    return int(getattr(engine, "world_size", 1))


def _rank(engine) -> int:
    return int(getattr(engine, "global_rank", 0))


def _barrier(engine) -> None:
    if _world(engine) > 1:
        from deepspeed_tpu_torch.comm import collectives

        collectives.barrier()


def _broadcast_tag(engine, tag: Optional[str]) -> Optional[str]:
    """Rank 0's tag on every rank (as it is, at one rank)."""
    if _world(engine) <= 1:
        return tag
    from deepspeed_tpu_torch.comm import collectives

    return collectives.broadcast_object(tag, src=0)


def _build_meta(engine, tag: str, client_state: Optional[dict]) -> Dict[str, Any]:
    """The JAX package's ``meta.json`` keys (``comm_state``: the shapes of
    the onebit strategy's residuals, null when the exchange keeps none)."""
    return {
        "tag": tag,
        "global_step": int(engine._host_global_step),
        "micro_step": int(engine._host_micro_step),
        "global_samples": int(engine.global_samples),
        "skipped_steps": int(engine.skipped_steps),
        "world_size": _world(engine),
        "dp_world_size": int(getattr(engine, "dp_world_size", 1)),
        "mp_world_size": int(engine.mesh.sizes["model"]) if hasattr(engine, "mesh") else 1,
        "zero_stage": engine.zero_stage,
        # whether the tag holds gradients of micro-steps still to be
        # applied (a save between micro-steps)
        "has_grad_acc": any(a is not None for a in engine._grad_acc),
        "comm_state": _comm_state_shape(engine),
        "client_state": client_state or {},
        "ds_tpu_version": _version(),
        **(engine._meta_extras() if hasattr(engine, "_meta_extras") else {}),
        # a sliced offload engine's slice count (absent: masters whole)
        **({"offload_shards": int(engine._offload_shards),
            "offload_blocks": int(engine._offload_blocks)} if _sharded_offload(engine) else {}),
    }


def _comm_state_shape(engine) -> Optional[list]:
    """The shapes of the onebit strategy's residuals in a tag (None: the
    exchange keeps no state)."""
    res = getattr(engine, "_comm_residuals", None)
    if res is None:
        return None
    n = int(engine.dp_world_size)
    return [[n, int(res[0].shape[0])], [n, int(res[1].shape[0])]]


def save_checkpoint(
    engine,
    save_dir: str,
    tag: Optional[str] = None,
    client_state: Optional[dict] = None,
    save_latest: bool = True,
    async_save: Optional[bool] = None,
) -> str:
    """Write one checkpoint tag.  ``async_save=None`` defers to the
    engine's ``overlap.async_checkpoint`` config: when an async writer is
    armed, the state is snapshotted to host (the only stall) and the
    stage->manifest->rename commit runs on a background thread — training
    resumes immediately and the returned path is where the tag WILL be
    committed (``engine._async_writer.drain()`` to wait).  Any save
    request drains an in-flight async save first."""
    rcfg = _resilience_cfg(engine)
    ck = rcfg.checkpoint
    if tag is None:
        tag = f"global_step{int(engine._host_global_step)}"
    tag = str(_broadcast_tag(engine, str(tag)))
    client_state = _merge_loader_state(engine, client_state)
    save_dir = os.path.abspath(save_dir)
    final_path = _ckpt_path(save_dir, tag)
    os.makedirs(save_dir, exist_ok=True)

    # the stall clock starts BEFORE the drain: waiting out the previous
    # in-flight commit is checkpoint-induced training stall and must
    # show up in the ckpt_stall phase, not hide in "other"
    timeline = getattr(engine, "timeline", None)
    t_stall = time.perf_counter()
    writer = getattr(engine, "_async_writer", None)
    if writer is not None:
        # sync saves drain too: they share the tree's staging/latest/GC
        # state with whatever commit is still in flight
        writer.drain()
    use_async = (writer is not None) if async_save is None else (bool(async_save) and writer is not None)
    if use_async:
        # the JAX package's blockers (its host-offload optimizer's files
        # are the port's state.pt entries, snapshotted like the rest); a
        # multi-rank save is collective, and its gathers must not run on
        # the writer thread
        blockers = []
        if _world(engine) > 1:
            blockers.append("multi-process saves are collective (staging barriers)")
        if not ck.atomic:
            blockers.append("'resilience.checkpoint.atomic' is off")
        if blockers:
            logger.warning(
                f"async checkpoint save unavailable ({'; '.join(blockers)}); saving synchronously"
            )
            use_async = False

    if use_async:
        path = _submit_async_save(
            engine, writer, save_dir, tag, final_path, rcfg, client_state, save_latest
        )
    else:
        path = _sync_save(engine, save_dir, tag, final_path, rcfg, client_state, save_latest)
    if timeline is not None:
        timeline.note("ckpt_stall", time.perf_counter() - t_stall)
    return path


def _commit_snapshot(save_dir: str, tag: str, final_path: str, target_atomic: bool,
                     snapshot: Dict[str, torch.Tensor], meta: Dict[str, Any], checksum: str,
                     files=None) -> None:
    """One attempt of the commit protocol: state, meta, manifest last, one
    rename (``target_atomic``), or straight into the tag's directory."""
    faults.check("ckpt.save.state", path=final_path)
    target = manager.begin_stage(save_dir, tag) if target_atomic else final_path
    os.makedirs(target, exist_ok=True)
    try:
        _write_state(target, snapshot, files)
        faults.check("ckpt.save.meta", path=target)
        atomic.atomic_write_text(os.path.join(target, "meta.json"), json.dumps(meta, indent=2))
        if target_atomic:
            # manifest last: its presence certifies completeness
            atomic.write_manifest(target, algorithm=checksum)
            manager.commit_tag(save_dir, tag)
    except OSError:
        if target_atomic:
            manager.abort_stage(save_dir, tag)
        raise
    finally:
        if target_atomic:
            # after this frame unwinds no live save owns the staging dir
            # (a real crash clears the in-memory registry with the
            # process; a simulated kill must match)
            manager.release_stage(save_dir, tag)


def _publish(save_dir: str, tag: str, rcfg, save_latest: bool) -> None:
    """After a commit: the ``latest`` pointer, then retention GC."""
    ck = rcfg.checkpoint
    if save_latest:
        retry_call(rcfg.retry.policy(), manager.write_latest, save_dir, tag)
    deleted = manager.retention_gc(
        save_dir, keep_last_n=ck.keep_last_n, keep_every=ck.keep_every, protect=(tag,)
    )
    if deleted:
        log_dist(f"retention gc: deleted old tag(s) {deleted} (keep_last_n={ck.keep_last_n})")


def _sync_save(
    engine,
    save_dir: str,
    tag: str,
    final_path: str,
    rcfg,
    client_state: Optional[dict],
    save_latest: bool,
) -> str:
    ck = rcfg.checkpoint
    meta = _build_meta(engine, tag, client_state)
    snapshot = _snapshot_state_to_host(engine)
    files = _rank_files(engine)
    if _world(engine) > 1:
        _multi_rank_commit(engine, save_dir, tag, final_path, rcfg, snapshot, meta, files)
    else:
        retry_call(
            rcfg.retry.policy(),
            _commit_snapshot, save_dir, tag, final_path, ck.atomic, snapshot, meta, ck.checksum,
            files,
            on_retry=lambda attempt, e, pause: logger.warning(
                f"checkpoint save of '{tag}' failed (attempt {attempt}: {e}); retrying in {pause:.1f}s"
            ),
        )
    if _rank(engine) == 0:
        _publish(save_dir, tag, rcfg, save_latest)
    _barrier(engine)  # no rank reads `latest` before it names this tag
    _note_ckpt_dir(engine, save_dir)
    log_dist(f"saved checkpoint {final_path}")
    return final_path


def _multi_rank_commit(engine, save_dir: str, tag: str, final_path: str, rcfg,
                       snapshot: Dict[str, torch.Tensor], meta: Dict[str, Any],
                       files=None) -> None:
    """The commit protocol across ranks: rank 0 stages; every rank writes
    its own files (:func:`_rank_files`) into the staging directory, and
    every rank learns whether all of them landed (a flag gathered from each,
    as the JAX package's between phases); then rank 0 writes the state,
    meta and manifest, and commits.  One attempt: a retry on one rank alone
    would desync the collectives and hang the job."""
    from deepspeed_tpu_torch.comm import collectives

    ck = rcfg.checkpoint
    faults.check("ckpt.save.state", path=final_path)
    rank0 = _rank(engine) == 0
    failed = None
    target = final_path
    if rank0:
        try:
            target = manager.begin_stage(save_dir, tag) if ck.atomic else final_path
            os.makedirs(target, exist_ok=True)
        except OSError as e:
            failed = e
    target = collectives.broadcast_object(target if failed is None else None, src=0)
    mine = None
    if target is not None and files:
        try:
            _write_state(target, None, files)
        except OSError as e:
            mine = repr(e)
    errors = [e for e in collectives.host_allgather(mine) if e is not None]
    if rank0 and failed is None:
        try:
            if errors:
                raise OSError(f"rank files failed: {errors}")
            _write_state(target, snapshot)
            faults.check("ckpt.save.meta", path=target)
            atomic.atomic_write_text(os.path.join(target, "meta.json"), json.dumps(meta, indent=2))
            if ck.atomic:
                atomic.write_manifest(target, algorithm=ck.checksum)
                manager.commit_tag(save_dir, tag)
        except OSError as e:
            if ck.atomic:
                manager.abort_stage(save_dir, tag)
            failed = e
        finally:
            if ck.atomic:
                manager.release_stage(save_dir, tag)
    # every rank learns whether the commit landed, then fails alike
    error = collectives.broadcast_object(None if failed is None else repr(failed), src=0)
    if failed is not None:
        raise failed
    if error is not None:
        raise OSError(f"checkpoint save of '{tag}' failed on rank 0: {error}")


def _submit_async_save(
    engine,
    writer,
    save_dir: str,
    tag: str,
    final_path: str,
    rcfg,
    client_state: Optional[dict],
    save_latest: bool,
) -> str:
    """Snapshot now (the only training stall), commit in the background.

    The background job is the SAME commit protocol as :func:`_sync_save`
    — stage into ``<tag>.tmp`` under the in-flight registry, meta,
    manifest last, one rename, latest pointer, retention GC — so every
    fault-injection durability property carries over: a kill at any
    background instruction leaves the previous tree (plus a ``.tmp``
    leftover) and never a loadable-but-corrupt tag."""
    ck = rcfg.checkpoint
    meta = _build_meta(engine, tag, client_state)
    snapshot = _snapshot_state_to_host(engine)
    files = _rank_files(engine)
    policy = rcfg.retry.policy()

    def commit() -> None:
        retry_call(
            policy,
            _commit_snapshot, save_dir, tag, final_path, True, snapshot, meta, ck.checksum,
            files, on_retry=lambda attempt, e, pause: logger.warning(
                f"async checkpoint save of '{tag}' failed (attempt {attempt}: {e}); "
                f"retrying in {pause:.1f}s"
            ),
        )
        _publish(save_dir, tag, rcfg, save_latest)
        log_dist(f"async checkpoint save of {final_path} committed")

    writer.submit(tag, final_path, commit)
    _note_ckpt_dir(engine, save_dir)
    log_dist(f"async checkpoint save of {final_path} submitted; training resumes")
    return final_path


def _pick_tag(load_dir: str, tag: Optional[str], explicit: bool, ck):
    """``(tag to load or None, requested tag, notes on the tags tried)``:
    the requested tag (or ``latest``) if it verifies, else the newest
    verified one; corrupt tags are quarantined."""
    requested = str(tag) if explicit else manager.read_latest(load_dir)
    if requested is None and not explicit:
        logger.warning(f"no '{LATEST_FILE}' file at {load_dir}; scanning for committed tags")
    tried: List[str] = []
    for cand in _load_candidates(load_dir, requested, explicit):
        path = _ckpt_path(load_dir, cand)
        if not os.path.isdir(path):
            tried.append(f"'{cand}': missing")
            continue
        if ck.verify_on_load:
            ok, notes = manager.verify_tag(load_dir, cand)
            if not ok:
                dest = manager.quarantine_tag(load_dir, cand)
                logger.warning(
                    f"checkpoint tag '{cand}' failed verification ({'; '.join(notes)}); "
                    f"quarantined to {os.path.basename(dest)}"
                )
                tried.append(f"'{cand}': corrupt ({notes[0]})")
                continue
            if notes:
                logger.warning(f"checkpoint tag '{cand}': {'; '.join(notes)}")
        if cand != requested:
            logger.warning(
                f"falling back to verified tag '{cand}' (requested "
                f"{'nothing' if requested is None else repr(requested)})"
            )
        return cand, requested, tried
    return None, requested, tried


def _load_candidates(load_dir: str, requested: Optional[str], explicit: bool) -> List[str]:
    """Tags to try, in order: the requested one first, then (unless the
    tag was named explicitly by the caller) every other committed tag
    newest-first — the fallback scan for a stale/corrupt ``latest``."""
    candidates: List[str] = [requested] if requested else []
    if not explicit:
        for t in manager.newest_first(load_dir):
            if t not in candidates:
                candidates.append(t)
    return candidates


def load_checkpoint(
    engine,
    load_dir: str,
    tag: Optional[str] = None,
    load_optimizer_states: bool = True,
    load_lr_scheduler_states: bool = True,
    load_module_only: bool = False,
    strict: Optional[bool] = None,
):
    """Returns ``(path, client_state)``, or ``(None, {})`` if nothing
    loadable was found.

    ``strict=True`` (or config ``resilience.checkpoint.fail_on_missing``)
    raises :class:`CheckpointNotFoundError` instead of the silent
    ``(None, {})``.  With ``verify_on_load`` (default), every candidate
    tag's manifest is re-checked first; corrupt tags are quarantined to
    ``<tag>.corrupt`` and the newest verified tag wins.
    """
    rcfg = _resilience_cfg(engine)
    ck = rcfg.checkpoint
    if strict is None:
        strict = ck.fail_on_missing
    writer = getattr(engine, "_async_writer", None)
    if writer is not None:
        # restoring while a background commit mutates the tree (rename,
        # latest update, GC) would race the candidate scan
        writer.drain()
    load_dir = os.path.abspath(load_dir)
    explicit = tag is not None
    picked = _pick_tag(load_dir, tag, explicit, ck) if _rank(engine) == 0 else None
    if _world(engine) > 1:
        # rank 0 scans, verifies and quarantines; every rank loads its pick
        from deepspeed_tpu_torch.comm import collectives

        picked = collectives.broadcast_object(picked, src=0)
    cand, requested, tried = picked
    if cand is not None:
        return _restore_tag(
            engine,
            _ckpt_path(load_dir, cand),
            load_optimizer_states=load_optimizer_states,
            load_lr_scheduler_states=load_lr_scheduler_states,
            load_module_only=load_module_only,
        )

    detail = f" (requested tag '{requested}')" if requested else ""
    attempts = f"; tried: {', '.join(tried)}" if tried else ""
    msg = f"no loadable checkpoint under {load_dir}{detail}{attempts}"
    if strict:
        raise CheckpointNotFoundError(
            msg + "; pass strict=False or set 'resilience.checkpoint.fail_on_missing' = false "
            "for the legacy (None, {}) return"
        )
    logger.warning(msg + "; nothing loaded")
    return None, {}


def _restore_tag(
    engine,
    path: str,
    load_optimizer_states: bool = True,
    load_lr_scheduler_states: bool = True,
    load_module_only: bool = False,
) -> Tuple[str, Dict[str, Any]]:
    meta_path = os.path.join(path, "meta.json")
    meta: Dict[str, Any] = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    # the 1-bit optimizers' state layout follows the tag's step count
    # before the engine's tensors are matched against it
    sync_phase = getattr(engine, "_sync_onebit_phase", None)
    if sync_phase is not None and not load_module_only:
        sync_phase(int(meta.get("global_step", 0)))
    restored = torch.load(os.path.join(path, STATE_DIR, STATE_FILE), map_location="cpu",
                          weights_only=True)
    return _finish_restore(
        engine, path, meta, restored,
        load_optimizer_states=load_optimizer_states,
        load_lr_scheduler_states=load_lr_scheduler_states,
        load_module_only=load_module_only,
    )


def _finish_restore(
    engine,
    path: str,
    meta: Dict[str, Any],
    restored: Dict[str, torch.Tensor],
    load_optimizer_states: bool,
    load_lr_scheduler_states: bool,
    load_module_only: bool,
) -> Tuple[str, Dict[str, Any]]:
    """Copy the tag's tensors into the engine's own, in place, and set the
    host counters (the engine's source of truth: the LR schedule reads
    the global step, the model's generator is seeded from the micro
    step).  As in the JAX package, ``load_module_only`` takes the
    parameters alone, ``load_optimizer_states=False`` the parameters, the
    loss scaler and the counters."""
    offload = getattr(engine, "_host_opt", None) is not None
    groups = {"params"}
    if not load_module_only:
        groups.add("loss_scale")
        if load_optimizer_states:
            groups |= {HOST_OPT if offload else "opt_state", "grad_acc"}
    restore_host = getattr(engine, "_restore_host", None)
    if restore_host is not None and (engine._masters_sharded or meta.get("masters_sharded")):
        # the streaming engine across fsdp, or a tag it wrote: reassembled
        # and cut to this engine's parts
        engine._host_buffers_idle()
        with torch.no_grad():
            restore_host(path, meta, restored, moments=HOST_OPT in groups)
            if "loss_scale" in groups:
                for sub, leaf in _walk(engine.loss_scale_state, ("loss_scale",)):
                    leaf.copy_(restored[_path_str(sub)])
        engine._after_host_load()
        groups = set()
    sliced = None
    if _sharded_offload(engine):
        # the slices' moments live in the shard files, not in state.pt
        sliced = (HOST_OPT in groups, (meta.get("offload_shards", 1),
                                       meta.get("offload_blocks", 1)))
        groups.discard(HOST_OPT)
        restored = {n: t for n, t in restored.items() if not n.startswith(HOST_OPT + "/")}
    reset_moments = HOST_OPT in groups and not any(n.startswith(HOST_OPT + "/") for n in restored)
    if reset_moments:
        logger.warning(
            f"host optimizer state not found in {path} (saved without offload, or under "
            "another offload shard layout): the f32 "
            "masters are rebuilt from its parameters and the Adam moments are being RESET")
        groups.discard(HOST_OPT)
    live = _state_tensors(engine)
    if "opt_state" in groups:
        groups.add("comm")
    live = {n: t for n, t in live.items() if n.split("/", 1)[0] in groups and n.split("/", 1)[0] != "grad_acc"}
    disk = {n for n in restored if n.split("/", 1)[0] in groups - {"grad_acc"}}
    if disk != set(live):
        raise ValueError(
            f"checkpoint {path} does not match this engine: missing {sorted(set(live) - disk)}, "
            f"unexpected {sorted(disk - set(live))}"
        )
    for name, t in live.items():
        src = restored[name]
        if src.shape != t.shape or src.dtype != t.dtype:
            raise ValueError(
                f"checkpoint {path} does not match this engine: '{name}' is "
                f"{src.dtype}{tuple(src.shape)}, the engine's {t.dtype}{tuple(t.shape)}"
            )
    with torch.no_grad():
        if not groups:
            pass
        elif offload:
            _copy_in_offload(engine, restored, groups, reset_moments, path, sliced)
        else:
            _copy_in(engine, restored, groups)
    if not load_module_only:
        engine._host_micro_step = int(restored["micro_step"])
        engine._host_global_step = int(restored["global_step"])
        engine.global_samples = int(restored["global_samples"])

    client_state: Dict[str, Any] = {}
    if meta:
        client_state = meta.get("client_state", {})
        engine.skipped_steps = meta.get("skipped_steps", 0)
        sched = engine.client_lr_scheduler
        if load_lr_scheduler_states and sched is not None and hasattr(sched, "load_state_dict"):
            sd = client_state.get("__lr_scheduler__")
            if sd:
                sched.load_state_dict(sd)
    # resume-cursor: hand the loader its saved epoch/batch position so a
    # restarted job neither replays nor skips batches
    _restore_loader_state(engine, client_state)
    _note_ckpt_dir(engine, os.path.dirname(path))
    log_dist(f"loaded checkpoint {path} (global_step={engine._host_global_step})")
    return path, client_state


def _copy_in(engine, restored: Dict[str, torch.Tensor], groups) -> None:
    """Copy whole tensors of a tag into the engine's own, in place, each
    cut to this rank's slice of its spec."""
    layout, n = engine.layout, len(engine._params)
    paths = [_path_str(p) for p, _ in _walk(engine._unflatten(list(range(n))))]
    # a tensor not of its leaf's shape (the 8-bit Adam state's block
    # scales) is whole on every rank: copied as it is
    put = lambda dst, i, spec, src: dst.copy_(  # noqa: E731
        layout.from_natural(i, src.to(dst.device), spec)
        if dst.dim() and tuple(src.shape) == tuple(layout.leaves[i].shape) else src)
    for i, name in enumerate(paths):
        put(engine._params[i], i, layout.leaves[i].param_spec, restored[f"params/{name}"])
    if "opt_state" in groups:
        frozen = getattr(engine, "_onebit_frozen", False)
        row = engine._dp_row() if frozen else None
        for field, x in _opt_fields(engine).items():
            if _per_leaf(engine, x):
                for i, name in enumerate(paths):
                    put(x[i], i, layout.leaves[i].opt_spec, restored[f"opt_state/{field}/{name}"])
            elif frozen and field != "step":
                # this model rank's state, of every model rank's
                src = restored[f"opt_state/{field}"]
                if field in ("worker_error", "server_error"):
                    # this rank's row of every rank's
                    src = src[:, row] if engine.mesh.sizes["model"] > 1 else src[row]
                x.copy_(engine._held_row(src))
            else:
                for sub, leaf in _walk(x, (field,)):
                    leaf.copy_(restored["opt_state/" + _path_str(sub)])
        if getattr(engine, "_comm_residuals", None) is not None:
            row = engine._dp_row()
            for t, key in zip(engine._comm_residuals, ("worker_error", "server_error")):
                src = restored[f"comm/{key}"]
                t.copy_(engine._held_row(src[:, row] if engine.mesh.sizes["model"] > 1
                                         else src[row]))
    if "loss_scale" in groups:
        for sub, leaf in _walk(engine.loss_scale_state, ("loss_scale",)):
            leaf.copy_(restored[_path_str(sub)])
    # gradients pending from the pre-restore parameters must not mix into
    # the restored run; the tag's own pending ones come back
    for i, name in enumerate(paths):
        acc = restored.get(f"grad_acc/{name}") if "grad_acc" in groups else None
        engine._grad_acc[i] = (None if acc is None else layout.from_natural(
            i, acc.to(engine.device), layout.leaves[i].acc_spec).clone())


def _copy_in_sliced(engine, restored: Dict[str, torch.Tensor], path: str, moments: bool,
                    saved_layout: Tuple[int, int]) -> None:
    """A sliced offload engine's restore (the JAX engine's
    ``_load_host_optimizer``, ``engine.py:1192-1246``): with ``moments``,
    each slice's masters and moments from its shard file; a tag saved under
    another slice layout (``saved_layout``: its slices a block and its
    blocks) rebuilds every slice's masters from ``params/`` and resets the
    moments, with the JAX package's warning.  Without ``moments``: the
    masters from ``params/`` only."""
    from deepspeed_tpu_torch.runtime.fp16.onebit.adam import pack_flat

    P, L = engine._offload_shards, engine._offload_slice_len
    same = moments and tuple(saved_layout) == (P, engine._offload_blocks)
    if moments and not same:
        logger.warning(
            f"host optimizer state {_shard_file(engine._host_shard_ids[0])} of this {P}-slice "
            f"layout not found: the tag {path} was saved under a different offload shard layout "
            f"({saved_layout[0]} slice(s) of {saved_layout[1]} block(s); process count / "
            "DS_OFFLOAD_SHARDS / model axis); Adam moments are being RESET from params")
    flat = None
    for i, opt in zip(engine._host_shard_ids, engine._host_opts):
        if same:
            opt.load_state_dict(torch.load(os.path.join(path, STATE_DIR, _shard_file(i)),
                                           map_location="cpu", weights_only=True))
            continue
        if flat is None:
            flat = pack_flat([engine._host_block(j, restored[f"params/{k}"])
                              for j, k in enumerate(engine._paths)], P)
        j = i % P
        opt.load_masters([flat[j * L:(j + 1) * L]])
        if moments:
            opt.reset_moments()


def _copy_in_offload(engine, restored: Dict[str, torch.Tensor], groups, reset_moments: bool,
                     path: str = "", sliced: Optional[bool] = None) -> None:
    """An offload engine's restore: the host masters from ``params/``, the
    moments from ``host_optimizer/`` (or reset; a sliced engine's from its
    shard files, :func:`_copy_in_sliced`), each cut to this rank's block,
    then the engine's compute-type parameters from the masters
    (``_after_host_load``)."""
    host = engine._host_opt
    engine._host_buffers_idle()  # no copy may still read the pinned buffers
    block = getattr(engine, "_host_block", lambda i, t: t)
    if sliced is not None:
        _copy_in_sliced(engine, restored, path, *sliced)
    elif HOST_OPT in groups:
        host.load_state_dict({
            **{f"master/{k}": block(i, restored[f"params/{k}"]) for i, k in enumerate(host.keys)},
            **{f"{x}/{k}": block(i, restored[f"{HOST_OPT}/{x}/{k}"])
               for i, k in enumerate(host.keys) for x in ("m", "v")},
        })
    else:
        host.load_masters([block(i, restored[f"params/{k}"]) for i, k in enumerate(host.keys)])
        if reset_moments:
            host.reset_moments()
    if "loss_scale" in groups:
        for sub, leaf in _walk(engine.loss_scale_state, ("loss_scale",)):
            leaf.copy_(restored[_path_str(sub)])
    if getattr(engine, "_grad_acc", None) is not None:
        keys = engine._paths if sliced is not None else host.keys
        for i, k in enumerate(keys):
            acc = restored.get(f"grad_acc/{k}") if "grad_acc" in groups else None
            engine._grad_acc[i] = None if acc is None else block(i, acc).to(engine.device).clone()
    engine._after_host_load()


def load_params(load_dir: str, tag: Optional[str] = None) -> Tuple[str, Dict[str, torch.Tensor]]:
    """``(tag path, {leaf path: CPU f32 tensor})``: the parameters of a tag
    this module wrote, whole and in their natural layout whatever mesh
    wrote them (``init_inference(checkpoint=...)``, the counterpart of the
    JAX engine's orbax restore of ``params``).  ``load_dir`` is a tag
    directory, or a save directory where ``tag`` (else ``latest``, else
    the newest verified tag) is picked as :func:`load_checkpoint` picks
    it: rank 0 scans, verifies and quarantines, and broadcasts its pick
    under a process group (call on every rank).  The state file is
    memory-mapped, so the optimizer state in it is never read."""
    from deepspeed_tpu_torch.comm import distributed
    from deepspeed_tpu_torch.config.config import ResilienceConfig

    path = os.path.abspath(load_dir)
    if not os.path.isfile(os.path.join(path, STATE_DIR, STATE_FILE)):
        picked = (_pick_tag(path, tag, tag is not None, ResilienceConfig().checkpoint)
                  if distributed.get_rank() == 0 else None)
        if distributed.get_world_size() > 1:
            from deepspeed_tpu_torch.comm import collectives

            picked = collectives.broadcast_object(picked, src=0)
        cand, requested, tried = picked
        if cand is None:
            detail = f" (requested tag '{requested}')" if requested else ""
            raise CheckpointNotFoundError(f"no loadable checkpoint under {path}{detail}"
                                          + (f"; tried: {', '.join(tried)}" if tried else ""))
        path = _ckpt_path(path, cand)
    state = torch.load(os.path.join(path, STATE_DIR, STATE_FILE), map_location="cpu",
                       weights_only=True, mmap=True)
    params = {n[len("params/"):]: t for n, t in state.items() if n.startswith("params/")}
    if not params:
        raise ValueError(f"checkpoint {path} holds no parameters")
    log_dist(f"loaded the parameters of {path}")
    return path, params


def consolidate_fp32_state_dict(engine) -> Dict[str, np.ndarray]:
    """The full f32 parameters on the host by the JAX package's leaf names
    (``blocks/qkv_w``): the ``zero_to_fp32.py`` analog, and the point
    where the port's and the JAX package's checkpoints meet."""
    return {_path_str(path): leaf.detach().float().cpu().numpy()
            for path, leaf in _walk(engine.params)}


def _version() -> str:
    from deepspeed_tpu_torch.version import __version__

    return __version__
