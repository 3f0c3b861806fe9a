"""Checkpoints — the port of pytorch_distributed_tpu/utils/checkpoint.py:
the params tier (``save_params``, ``load_params``, ``params_path``,
``save_best_score``, ``load_best_score``, :108-160) and the tier of
crash-consistent checkpoint epochs (:396-848, with ``CheckpointMismatch``
and ``validate_snapshot`` :79, :282-349, the RNG helpers :356-365 and
``await_epoch`` :717-733, which a rejoining learner replica polls for its
barrier epoch; a replica's epoch carries ``replica_round`` and
``replica_ingest_counter`` in its extras).
The reference's legacy single-snapshot tier is not ported.

The files are the port's own: ``torch.save`` of the model's state_dict
(fp32 CPU tensors) at ``{model_name}.pt``, with the reference's path
scheme (``models/{refs}``) and its ``_best`` tier: ``{model_name}_best.pt``
holds the weights of the highest evaluation so far, and the sidecar
``{model_name}_best.json`` the score they earned.  Every write goes to a
temporary file first and is renamed into place, so a reader never sees a
torn file.  The reference's ``.msgpack`` files are not read.

Checkpoint epochs are versioned ``{model_name}_ckpt/epoch_<k>/``
directories, each holding the train state (``state.pt``), the ring's
contents when asked (``replay.npz``) and ``extras.json`` (clocks,
counters, the best evaluation, the generators' states), all captured at
one moment and committed together by an atomic ``MANIFEST.json`` rename
that records a sha256 digest and the size of each artifact.  Readers
(``resolve_epoch``) take the newest epoch whose manifest exists and
verifies, and skip epochs fenced off by ``ROLLED_BACK.json``; so a
SIGKILL at any point of a save leaves either the new epoch committed or
the previous one untouched.  ``gc_epochs`` keeps the newest ``retain``;
``fsck`` (``python -m pytorch_distributed_tpu_torch.ckpt_fsck ROOT``)
checks a root offline, also one the JAX package wrote.

Where the port differs: the state artifact is one file, a ``torch.save``
of the ``TrainState`` as fp32 and integer CPU tensors (nested dicts: the
decoupled DDPG state's params, targets and Adam states are ``{"actor",
"critic"}`` pairs), not an Orbax directory, and its manifest key is its
file name; a torch generator's
state goes into the extras as a list of ints.  Every save consults the
``CKPT_FAULTS`` injector (utils/faults.py) at the reference's six write
points (``_FRAME_POINTS``), so a drill can SIGKILL a save at an exact
boundary.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from pytorch_distributed_tpu_torch.ops.losses import AdamState, TrainState
from pytorch_distributed_tpu_torch.utils.faults import FaultInjector

EXT = ".pt"


def _replace_atomic(path: str, write) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)
    return path


def save_params(path: str, params: Dict[str, torch.Tensor]) -> str:
    """Write a params-only checkpoint.  Returns the path."""
    cpu = {k: v.detach().to("cpu", torch.float32) for k, v in params.items()}
    return _replace_atomic(path, lambda tmp: torch.save(cpu, tmp))


def load_params(path: str) -> Dict[str, torch.Tensor]:
    return torch.load(path, map_location="cpu", weights_only=True)


def params_path(model_name: str) -> str:
    """``models/{refs}.pt``: the reference's scheme with the port's
    extension."""
    return model_name + EXT


def best_score_path(model_name: str) -> str:
    return model_name + "_best.json"


def save_best_score(model_name: str, reward: float,
                    step: Optional[int] = None) -> None:
    """The score the ``_best`` weights earned; written before the weights,
    so a crash between the two leaves the threshold ahead of the file and
    never lets a worse policy overwrite a better one.  An epoch carries
    the best score too, but an evaluation can beat it between two
    commits: resume takes the larger of the two (agents/learner.py)."""
    os.makedirs(os.path.dirname(best_score_path(model_name)) or ".",
                exist_ok=True)
    _write_json_atomic(best_score_path(model_name),
                       {"best_eval_reward": float(reward), "step": step})


def load_best_score(model_name: str) -> float:
    """The sidecar's score; -inf when absent or unreadable."""
    try:
        with open(best_score_path(model_name)) as f:
            return float(json.load(f)["best_eval_reward"])
    except (OSError, ValueError, KeyError):
        return float("-inf")


# ---------------------------------------------------------------------------
# checkpoint epochs
# ---------------------------------------------------------------------------

MANIFEST = "MANIFEST.json"
MANIFEST_FORMAT = 1
STATE = "state.pt"
REPLAY = "replay.npz"
EXTRAS = "extras.json"
_EPOCH_PREFIX = "epoch_"
# a committed epoch fenced off from resume (a rollback passed it): kept on
# disk, digest-intact, but never resumed from; fsck reports it as
# ``rolled-back``, not as a violation
ROLLED_BACK = "ROLLED_BACK.json"

# the write points of one save, in order: ``kill@N`` in CKPT_FAULTS ends
# the process at frame ``FRAMES_PER_SAVE * save_index + point``
_FRAME_POINTS = (
    "begin",          # 0: before the epoch dir is (re)created
    "mid_state",      # 1: the state's tmp file written, not renamed in
    "after_state",    # 2: state durable; replay not yet written
    "mid_replay",     # 3: replay tmp written, not yet renamed in
    "pre_commit",     # 4: all artifacts written, manifest not committed
    "post_commit",    # 5: manifest committed, GC not yet run
)
FRAMES_PER_SAVE = len(_FRAME_POINTS)


class CheckpointMismatch(RuntimeError):
    """A restored snapshot does not fit the live run's configuration (the
    ring's row shape or dtype changed between save and resume)."""


_faults_box: list = [None]


def _faults() -> FaultInjector:
    """The process's injector for the checkpoint plane (``CKPT_FAULTS``):
    one frame counter across every save of the process."""
    if _faults_box[0] is None:
        _faults_box[0] = FaultInjector.from_env("ckpt")
    return _faults_box[0]


def serialize_np_rng(rng) -> dict:
    """JSON-able state of a numpy Generator."""
    return rng.bit_generator.state


def restore_np_rng(rng, state: Optional[dict]) -> bool:
    if not state:
        return False
    rng.bit_generator.state = state
    return True


def serialize_torch_rng(gen: torch.Generator) -> List[int]:
    """A torch generator's state (a uint8 tensor) as a list of ints."""
    return gen.get_state().tolist()


def restore_torch_rng(gen: torch.Generator, state: Optional[list]) -> bool:
    """``set_state`` takes a uint8 CPU tensor, for a CUDA generator too."""
    if not state:
        return False
    gen.set_state(torch.tensor(state, dtype=torch.uint8))
    return True


def ckpt_root(model_name: str) -> str:
    return os.path.abspath(model_name + "_ckpt")


def _epoch_dir(root: str, k: int) -> str:
    return os.path.join(root, f"{_EPOCH_PREFIX}{k}")


def _epoch_num(name: str) -> Optional[int]:
    if not name.startswith(_EPOCH_PREFIX):
        return None
    try:
        return int(name[len(_EPOCH_PREFIX):])
    except ValueError:
        return None


def _list_epochs(root: str) -> List[Tuple[int, str]]:
    """(k, path) of every epoch-shaped directory under ``root``, newest
    first."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        k = _epoch_num(name)
        p = os.path.join(root, name)
        if k is not None and os.path.isdir(p):
            out.append((k, p))
    return sorted(out, reverse=True)


def _digest_file(path: str) -> Tuple[str, int]:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for blk in iter(lambda: f.read(1 << 20), b""):
            h.update(blk)
    return h.hexdigest(), os.path.getsize(path)


def _digest_tree(root: str) -> Tuple[str, int, int]:
    """The digest of a directory artifact (the JAX package's Orbax
    ``state/``): sha256 over the sorted relative paths and contents.
    Returns (hexdigest, total bytes, file count)."""
    h = hashlib.sha256()
    total = nfiles = 0
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for fn in sorted(filenames):
            p = os.path.join(dirpath, fn)
            h.update(os.path.relpath(p, root).encode() + b"\0")
            with open(p, "rb") as f:
                for blk in iter(lambda: f.read(1 << 20), b""):
                    h.update(blk)
            total += os.path.getsize(p)
            nfiles += 1
    return h.hexdigest(), total, nfiles


def _fsync_dir(path: str) -> None:
    fd = os.open(path or ".", os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_json_atomic(path: str, obj: dict) -> None:
    """tmp write, fsync, rename, fsync of the directory: the commit
    primitive.  After the rename the file is the complete new content or
    absent; a reader never sees a torn one."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))


def _write_file_atomic(path: str, write, faults=None) -> None:
    """``write(tmp)``, fsync, then the rename; the fault frame falls
    between the write and the rename."""
    tmp = path + ".tmp"
    write(tmp)
    if faults is not None:
        faults.frame()
    with open(tmp, "rb") as f:
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _savez(path: str, data: dict) -> None:
    # through a file object: given a name, numpy appends ``.npz`` to it
    with open(path, "wb") as f:
        np.savez_compressed(f, **data)


def _to_tree(x):
    """A train-state part as nested dicts of CPU tensors; an
    ``AdamState`` becomes ``{"count", "mu", "nu"}``."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu").clone()
    if isinstance(x, AdamState):
        x = x._asdict()
    return {k: _to_tree(v) for k, v in x.items()}


def _from_tree(d, device):
    """``_to_tree``'s inverse, on ``device``."""
    if isinstance(d, torch.Tensor):
        return d.to(device)
    if set(d) == set(AdamState._fields):
        return AdamState(*(_from_tree(d[f], device)
                           for f in AdamState._fields))
    return {k: _from_tree(v, device) for k, v in d.items()}


def _state_dict(state: TrainState) -> dict:
    """The train state as fp32 and integer CPU tensors, nested as it is:
    one net's params and one Adam state, or DDPG's ``{"actor",
    "critic"}`` pairs of each."""
    return {f: _to_tree(v) for f, v in state._asdict().items()}


@dataclass
class EpochInfo:
    """A resolved (complete, digest-valid) checkpoint epoch."""

    path: str
    epoch: int
    learner_step: int
    manifest: dict
    extras: dict = field(default_factory=dict)

    @property
    def has_state(self) -> bool:
        return STATE in self.manifest.get("artifacts", {})

    @property
    def has_replay(self) -> bool:
        return REPLAY in self.manifest.get("artifacts", {})


def save_epoch(model_name: str, state: Optional[TrainState] = None,
               memory: Any = None, extras: Optional[dict] = None,
               retain: int = 3) -> str:
    """Write one checkpoint epoch and commit it atomically.

    The artifacts, captured at this call: ``state.pt`` (the train state,
    read once to the host), ``replay.npz`` (``memory.snapshot()``, when a
    memory is given) and ``extras.json`` (the caller's dict).  Readers see
    the epoch only after the final ``MANIFEST.json`` rename; a crash
    before it leaves an uncommitted ``epoch_<k>`` that readers skip and
    the next save clears.  After the commit, committed epochs beyond
    ``retain`` are removed.  Returns the epoch's path; any failure
    raises."""
    faults = _faults()
    faults.frame()  # begin
    root = ckpt_root(model_name)
    os.makedirs(root, exist_ok=True)
    committed = [k for k, p in _list_epochs(root)
                 if os.path.exists(os.path.join(p, MANIFEST))]
    k = (committed[0] + 1) if committed else 0
    ed = _epoch_dir(root, k)
    if os.path.isdir(ed):  # uncommitted debris of a crashed save
        shutil.rmtree(ed)
    os.makedirs(ed)

    artifacts: Dict[str, dict] = {}
    learner_step = int((extras or {}).get("learner_step", -1))
    if state is not None:
        host = _state_dict(state)
        if learner_step < 0:
            learner_step = int(host["step"])
        sp = os.path.join(ed, STATE)
        _write_file_atomic(sp, lambda tmp: torch.save(host, tmp),
                           faults=faults)  # mid_state
        digest, nbytes = _digest_file(sp)
        artifacts[STATE] = {"sha256": digest, "bytes": nbytes}
    else:
        faults.frame()  # keeps the frame schedule's positions

    faults.frame()  # after_state
    data = memory.snapshot() if memory is not None else None
    if data is not None:
        rp = os.path.join(ed, REPLAY)
        _write_file_atomic(rp, lambda tmp: _savez(tmp, data),
                           faults=faults)  # mid_replay
        digest, nbytes = _digest_file(rp)
        artifacts[REPLAY] = {"sha256": digest, "bytes": nbytes,
                             "rows": int(len(data.get("reward", ())))}
    else:
        faults.frame()  # mid_replay's place

    ep = os.path.join(ed, EXTRAS)
    _write_json_atomic(ep, dict(extras or {}))
    digest, nbytes = _digest_file(ep)
    artifacts[EXTRAS] = {"sha256": digest, "bytes": nbytes}

    faults.frame()  # pre_commit
    _write_json_atomic(os.path.join(ed, MANIFEST), {
        "format": MANIFEST_FORMAT,
        "epoch": k,
        "learner_step": learner_step,
        "wall": time.time(),
        "artifacts": artifacts,
    })
    faults.frame()  # post_commit
    gc_epochs(root, retain=retain, in_progress=k)
    return ed


def epoch_bytes(path: str) -> int:
    """The bytes of a committed epoch's artifacts, from its manifest."""
    with open(os.path.join(path, MANIFEST)) as f:
        arts = json.load(f)["artifacts"]
    return sum(int(m.get("bytes", 0)) for m in arts.values())


def mark_rolled_back(path: str, to_epoch: Optional[int] = None,
                     reason: str = "") -> None:
    """Fence a committed epoch off from resume: an atomic marker write;
    idempotent."""
    _write_json_atomic(os.path.join(path, ROLLED_BACK), {
        "wall": time.time(), "rolled_back_to": to_epoch, "reason": reason})


def fence_epochs_after(model_name: str, after_epoch: int,
                       reason: str = "") -> List[int]:
    """Mark every committed epoch numbered above ``after_epoch`` as
    rolled back.  Returns the epoch numbers newly fenced."""
    fenced = []
    for k, path in _list_epochs(ckpt_root(model_name)):
        if k > after_epoch \
                and os.path.exists(os.path.join(path, MANIFEST)) \
                and not os.path.exists(os.path.join(path, ROLLED_BACK)):
            mark_rolled_back(path, to_epoch=after_epoch, reason=reason)
            fenced.append(k)
    return fenced


def verify_epoch(path: str) -> Tuple[str, List[str]]:
    """(status, violations) of one epoch directory:

    - ``complete``: the manifest is there and well formed, every
      artifact's digest and size verify, the extras agree with it;
    - ``incomplete``: no manifest (a crash in a save; debris, not a
      violation);
    - ``rolled-back``: committed but fenced off (``ROLLED_BACK.json``);
    - ``corrupt``: the manifest lies; every lie is listed.

    A ``state`` directory artifact (the JAX package's Orbax state) is
    digested as a tree, every other artifact as a file."""
    mp = os.path.join(path, MANIFEST)
    if not os.path.exists(mp):
        return "incomplete", []
    if os.path.exists(os.path.join(path, ROLLED_BACK)):
        return "rolled-back", []
    bad: List[str] = []
    try:
        with open(mp) as f:
            man = json.load(f)
    except (OSError, ValueError) as e:
        return "corrupt", [f"{mp}: manifest unreadable ({e})"]
    arts = man.get("artifacts") if isinstance(man, dict) else None
    if not isinstance(arts, dict) or "epoch" not in man:
        return "corrupt", [f"{mp}: manifest missing required keys"]
    k = _epoch_num(os.path.basename(path))
    if k is not None and man["epoch"] != k:
        bad.append(f"{mp}: manifest epoch {man['epoch']} != dir epoch {k}")
    for name, meta in arts.items():
        ap = os.path.join(path, name)
        if name == "state":
            if not os.path.isdir(ap):
                bad.append(f"{ap}: state dir missing")
                continue
            digest, nbytes, _nfiles = _digest_tree(ap)
        elif not os.path.exists(ap):
            bad.append(f"{ap}: artifact missing")
            continue
        else:
            digest, nbytes = _digest_file(ap)
        if digest != meta.get("sha256"):
            bad.append(f"{ap}: content digest mismatch "
                       f"(torn or modified after commit)")
        if meta.get("bytes") is not None \
                and int(meta["bytes"]) != int(nbytes):
            bad.append(f"{ap}: size mismatch — manifest says "
                       f"{int(meta['bytes'])} bytes, on disk "
                       f"{int(nbytes)} (truncated or padded after "
                       f"commit)")
    if EXTRAS in arts and not any(EXTRAS in b for b in bad):
        try:
            with open(os.path.join(path, EXTRAS)) as f:
                extras = json.load(f)
        except (OSError, ValueError) as e:
            extras = None
            bad.append(f"{path}/{EXTRAS}: unreadable ({e})")
        if extras is not None:
            es = int(extras.get("learner_step", man.get("learner_step", -1)))
            if es != int(man.get("learner_step", -1)):
                bad.append(
                    f"{path}: extras learner_step {es} != manifest "
                    f"learner_step {man.get('learner_step')}")
    return ("complete" if not bad else "corrupt"), bad


def resolve_epoch(model_name: str,
                  before: Optional[int] = None) -> Optional[EpochInfo]:
    """The newest complete epoch under ``{model_name}_ckpt``, or None.
    Incomplete, corrupt and fenced epochs are skipped (a corrupt one with
    a note).  ``before`` keeps to epochs numbered strictly below it: the
    rollback ladder's step to a restore point older than the last one."""
    for k, path in _list_epochs(ckpt_root(model_name)):
        if before is not None and k >= before:
            continue
        status, bad = verify_epoch(path)
        if status == "complete":
            with open(os.path.join(path, MANIFEST)) as f:
                man = json.load(f)
            extras = {}
            if os.path.exists(os.path.join(path, EXTRAS)):
                with open(os.path.join(path, EXTRAS)) as f:
                    extras = json.load(f)
            return EpochInfo(path=path, epoch=k,
                             learner_step=int(man.get("learner_step", -1)),
                             manifest=man, extras=extras)
        if status == "corrupt":
            print(f"[checkpoint] skipping corrupt epoch {path}: "
                  + "; ".join(bad), flush=True)
    return None


def await_epoch(model_name: str, min_step: int, timeout: float = 30.0,
                poll: float = 0.1) -> Optional[EpochInfo]:
    """Poll ``resolve_epoch`` until a complete epoch with ``learner_step >=
    min_step`` appears, or None after ``timeout`` (reference :717-733):
    a rejoining replica loads the barrier epoch its lead commits, and the
    manifest's atomic rename means the poll never sees a torn one."""
    deadline = time.monotonic() + timeout
    while True:
        info = resolve_epoch(model_name)
        if info is not None and info.learner_step >= min_step:
            return info
        if time.monotonic() >= deadline:
            return None
        time.sleep(poll)


def load_epoch_state(info: EpochInfo, device="cpu") -> TrainState:
    """The epoch's train state, on ``device``."""
    if not info.has_state:
        raise FileNotFoundError(f"epoch {info.epoch} at {info.path} holds "
                                f"no {STATE}")
    d = torch.load(os.path.join(info.path, STATE), map_location="cpu",
                   weights_only=True)
    return TrainState(**{f: _from_tree(d[f], device)
                         for f in TrainState._fields})


def load_epoch_replay(info: EpochInfo, memory: Any) -> int:
    """Refill ``memory`` from the epoch's ``replay.npz``.  Returns the rows
    restored (0 when the epoch holds none).  Raises
    ``CheckpointMismatch`` when the rows do not fit the live ring."""
    if not info.has_replay:
        return 0
    with np.load(os.path.join(info.path, REPLAY)) as z:
        data = {k: z[k] for k in z.files}
    validate_snapshot(memory, data, source=f"epoch {info.epoch} replay")
    return int(memory.restore(data))


def validate_snapshot(memory: Any, data: dict,
                      source: str = "snapshot") -> None:
    """Hold a ring snapshot against the live ring's row shape and state
    dtype and raise a ``CheckpointMismatch`` that names the field: its
    family (segment or transition rows), and for segment rows the obs
    window's shape and the carry's width (reference :296-333).  A
    different capacity is legal: a restore keeps the newest rows that
    fit, and a shrink is reported."""
    mem = memory.replay if getattr(memory, "replay", None) is not None \
        else memory
    mem = getattr(mem, "memory", mem)  # a queue owner's host ring
    name = type(mem).__name__

    def bail(msg: str) -> None:
        raise CheckpointMismatch(
            f"{source} does not fit the live {name}: {msg} "
            f"(memory/model config changed between save and resume?)")

    snap_is_seq = "obs" in data and "mask" in data
    mem_is_seq = hasattr(mem, "T")  # both segment rings
    if snap_is_seq != mem_is_seq:
        kinds = lambda seq: "segment" if seq else "transition"
        bail(f"snapshot holds {kinds(snap_is_seq)} rows but the memory "
             f"stores {kinds(mem_is_seq)} rows")
    if mem_is_seq:
        obs = np.asarray(data["obs"])
        want = getattr(mem, "obs_shape", None)
        if want is None:  # the host ring
            want = tuple(np.shape(mem.obs)[1:])
        if len(obs) and tuple(obs.shape[1:]) != tuple(want):
            bail(f"segment obs rows are {tuple(obs.shape[1:])}, live ring "
                 f"stores {tuple(want)} (seq_len/pack_frames/state shape "
                 f"changed)")
        c0 = np.asarray(data.get("c0", np.zeros((0, 0))))
        if len(c0) and c0.shape[1] != mem.lstm_dim:
            bail(f"carry width {c0.shape[1]} != live lstm_dim "
                 f"{mem.lstm_dim}")
    else:
        _validate_transitions(mem, data, bail)
    cap = getattr(mem, "capacity", None)
    rows = len(np.asarray(data.get("reward", ())))
    if cap is not None and rows > cap:
        print(f"[checkpoint] note: {source} holds {rows} rows, live "
              f"{name} capacity is {cap} — restoring the newest {cap}",
              flush=True)


def _validate_transitions(mem, data: dict, bail) -> None:
    st = np.asarray(data["state0"])
    want = getattr(mem, "state_shape", None)
    if want is not None and len(st) and tuple(st.shape[1:]) != tuple(want):
        bail(f"state rows are {tuple(st.shape[1:])}, live memory stores "
             f"{tuple(want)}")
    col = getattr(getattr(mem, "state", None), "state0", None)
    if col is not None and len(st):
        want_dt = torch.empty(0, dtype=col.dtype).numpy().dtype
        if np.dtype(st.dtype) != want_dt:
            bail(f"state dtype {st.dtype} != live {want_dt}")


def gc_epochs(root: str, retain: int = 3,
              in_progress: Optional[int] = None) -> List[str]:
    """Remove committed epochs beyond the newest ``retain`` and any
    uncommitted debris (but not ``in_progress``, an epoch a caller is
    writing).  Fenced epochs do not count against ``retain``; they are
    kept while newer than the oldest retained good epoch.  Returns the
    paths removed."""
    removed = []
    committed, rolled = [], []
    for k, path in _list_epochs(root):
        if os.path.exists(os.path.join(path, MANIFEST)):
            (rolled if os.path.exists(os.path.join(path, ROLLED_BACK))
             else committed).append((k, path))
        elif k != in_progress:
            shutil.rmtree(path, ignore_errors=True)
            removed.append(path)
    kept = committed[:max(retain, 1)]
    for _k, path in committed[max(retain, 1):]:
        shutil.rmtree(path, ignore_errors=True)
        removed.append(path)
    if kept:
        floor = kept[-1][0]  # the oldest retained good epoch
        for k, path in rolled:
            if k < floor:
                shutil.rmtree(path, ignore_errors=True)
                removed.append(path)
    return removed


def fsck(root: str) -> dict:
    """Offline check of a checkpoint root.  Returns a report;
    ``violations`` non-empty means a committed epoch lies about its
    contents (incomplete epochs are crash debris and only listed)."""
    report: dict = {"root": root, "epochs": [], "violations": [],
                    "newest_complete": None, "rolled_back": 0}
    if not os.path.isdir(root):
        report["violations"].append(f"{root}: no such directory")
        return report
    complete_steps: List[Tuple[int, int]] = []
    for k, path in _list_epochs(root):
        status, bad = verify_epoch(path)
        entry = {"epoch": k, "status": status, "violations": bad}
        if status in ("complete", "rolled-back"):
            with open(os.path.join(path, MANIFEST)) as f:
                man = json.load(f)
            entry["learner_step"] = man.get("learner_step")
            entry["artifacts"] = {
                name: int(meta.get("bytes", 0))
                for name, meta in (man.get("artifacts") or {}).items()}
            entry["bytes"] = sum(entry["artifacts"].values())
        if status == "complete":
            if report["newest_complete"] is None:
                report["newest_complete"] = k
            if entry["learner_step"] is not None:
                complete_steps.append((k, int(entry["learner_step"])))
        elif status == "rolled-back":
            report["rolled_back"] += 1
        report["epochs"].append(entry)
        report["violations"].extend(bad)
    # the learner step grows with the epoch number across resumable
    # epochs; fenced ones are left out above
    for (k_new, s_new), (k_old, s_old) in zip(complete_steps,
                                              complete_steps[1:]):
        if s_new < s_old:
            report["violations"].append(
                f"{root}: epoch {k_new} learner_step {s_new} regressed "
                f"below epoch {k_old}'s {s_old} (an unmarked rollback?)")
    return report
