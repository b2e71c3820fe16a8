"""The serving artifact: a `torch.export` program that carries its own
kernels, and the loader that runs it with nothing but torch.

`save_artifact` writes `<path>` (`torch.export.save` of the serving
program) with, as extra files, its platforms, the op library the
program calls (`libleod_ops-<build>.so`, which defines the
`leod_tpu_torch::` ops, their CPU implementations and, in a card build,
their CUDA kernels; base64), and the library's sha256, build, variant
("cuda-sm_90a" or "cpu") and the torch version it was built against;
and `<path>.json`, the caller's meta, the platforms and that record.

`load_exported` registers the ops before it loads the program: where
the process has none, it writes the carried library to a cache
directory keyed by its sha256 and loads it; where the process has them
from the same build (the package's, or another artifact's), it reuses
them. Another build, another torch or a library without the CUDA
kernels for a card raises and names both sides: a process holds one
build of the ops, and a program never runs another build's kernels.
An artifact without a library (written before artifacts carried one)
loads only where the caller brings the ops (`ops_loader`: the package's
`ops._build.load`).

Trust an artifact as you would an executable: loading it loads the
native library it carries, whose static initialisers run at that
moment. Its sha256 is checked against the record stored in the same
artifact, which catches a corrupted file but says nothing of where the
library came from. A caller that knows which library it expects pins
its sha256 (`sha256=`, `--sha256`), and the loader refuses any other
before it loads anything.

This module imports only torch and the standard library, so it runs as
a lone file, in a process that has neither this package nor the CUDA
toolkit:

    python -I artifact.py ART.pt2 --inputs IN.pt --out OUT.pt \
        [--device cpu] [--sha256 HEX]

runs the steps in IN.pt ({"ev", "reset", "active"}: a list of tensors
each, one per step; optional "states", else zeros of the program's
state shapes) from zero states and writes OUT.pt: each step's states,
dets and valid (run on the card unless `--device cpu`; saved on the
CPU), each step's launches as the library counts
them, the load seconds (in all, and of the ops, the program and its
module), each step's milliseconds, and the library's record.
"""
from __future__ import annotations

import argparse
import base64
import hashlib
import json
import os
import sys
import tempfile
import time
import warnings
import zipfile
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

LIBRARY = "op_library"                 # the extra files' names
LIBRARY_RECORD = "op_library.json"
PLATFORMS = "platforms"
_TAG = b"LEOD_OPS_INFO"                # csrc/torch_ops.cpp `leod_ops_info`


def library_info(data: bytes) -> Dict[str, str]:
    """The build, variant and torch version an op library was built
    with, read from its bytes (the string `leod_ops_info`)."""
    at = data.find(_TAG)
    if at < 0:
        raise ValueError("not an op library of leod_tpu_torch: no "
                         "LEOD_OPS_INFO string in it")
    end = data.index(b"\0", at)
    return json.loads(data[at + len(_TAG):end].decode())


def loaded_ops() -> Optional[Dict[str, str]]:
    """The build of the op library this process has registered (build,
    variant, torch, path), or None where it has none."""
    if not hasattr(torch.ops.leod_tpu_torch, "build_info"):
        return None
    return json.loads(torch.ops.leod_tpu_torch.build_info())


def launch_counts() -> Dict[str, int]:
    """Each op's launches, as the loaded library counts them."""
    return json.loads(torch.ops.leod_tpu_torch.launch_counts())


def _describe(info: Dict[str, str]) -> str:
    where = f", {info['path']}" if info.get("path") else ""
    return (f"build {info['build']} ({info['variant']}, torch "
            f"{info['torch']}{where})")


def save_artifact(exported: torch.export.ExportedProgram, path: str,
                  meta: Dict[str, Any], library: Optional[str] = None
                  ) -> Dict[str, Any]:
    """Write the artifact `<path>` and its sidecar `<path>.json`. The
    library is the op library this process has loaded (the one the
    program was traced with) unless `library` names another file.
    Returns the library's record."""
    platforms = list(exported.platforms)
    if library is None:
        have = loaded_ops()
        if have is None:
            raise RuntimeError("no op library is loaded: export the program "
                               "first, or pass library=")
        library = have["path"]
    with open(library, "rb") as f:
        data = f.read()
    record = {**library_info(data),
              "sha256": hashlib.sha256(data).hexdigest(), "bytes": len(data)}
    if "cuda" in platforms and not record["variant"].startswith("cuda"):
        warnings.warn(f"{path} is for {platforms} but carries "
                      f"{_describe(record)}, without the CUDA kernels: it "
                      "will not run on a card; export it where the kernels "
                      "build")
    torch.export.save(exported, path, extra_files={
        PLATFORMS: json.dumps(platforms),
        LIBRARY: base64.b64encode(data).decode("ascii"),
        LIBRARY_RECORD: json.dumps(record)})
    with open(path + ".json", "w") as f:
        json.dump({**meta, "platforms": platforms, LIBRARY: record}, f,
                  indent=2)
    return record


def read_extra(path: str, name: str) -> Optional[bytes]:
    """An extra file of a `torch.export.save` archive, or None."""
    with zipfile.ZipFile(path) as z:
        for entry in z.namelist():
            if entry.endswith(f"/extra/{name}"):
                return z.read(entry)
    return None


def _cached(data: bytes, sha: str, cache_dir: Optional[str]) -> str:
    """The library's bytes as a file in the cache, keyed by its sha256."""
    cache_dir = cache_dir or os.path.join(tempfile.gettempdir(),
                                          "leod_tpu_torch_ops")
    os.makedirs(cache_dir, exist_ok=True)
    out = os.path.join(cache_dir, f"libleod_ops-{sha}.so")
    if os.path.exists(out):
        with open(out, "rb") as f:
            if hashlib.sha256(f.read()).hexdigest() == sha:
                return out
    tmp = f"{out}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, out)
    return out


def load_ops(path: str, cache_dir: Optional[str] = None,
             ops_loader: Optional[Callable[[], Any]] = None,
             sha256: Optional[str] = None) -> Dict[str, str]:
    """Register the ops the artifact at `path` calls; returns the loaded
    build's record. Raises where the process has another build, where
    this torch is not the library's, where the artifact carries no
    library and no `ops_loader` is given, and, with `sha256`, where the
    carried library is not the one pinned."""
    raw = read_extra(path, LIBRARY)
    if raw is None:
        if sha256 is not None:
            raise RuntimeError(f"{path} carries no op library; sha256 "
                               f"{sha256} was pinned")
        if ops_loader is None:
            raise RuntimeError(
                f"{path} carries no op library (it was exported before "
                "artifacts carried one): load it in a process that imports "
                "leod_tpu_torch, or export it again")
        ops_loader()
        return loaded_ops()
    record = json.loads(read_extra(path, LIBRARY_RECORD))
    if sha256 is not None and record["sha256"] != sha256:
        raise RuntimeError(f"{path} carries the op library with sha256 "
                           f"{record['sha256']}, not the pinned {sha256}")
    if record["torch"] != torch.__version__:
        raise RuntimeError(
            f"the artifact's op library is {_describe(record)}; this "
            f"process runs torch {torch.__version__}. An artifact loads "
            "only under the torch it was exported with")
    have = loaded_ops()
    if have is None:
        data = base64.b64decode(raw)
        sha = hashlib.sha256(data).hexdigest()
        if sha != record["sha256"] or library_info(data)["build"] != \
                record["build"]:
            raise RuntimeError(f"{path}: the op library's bytes do not match "
                               f"its record (sha256 {sha}, record "
                               f"{record['sha256']})")
        torch.ops.load_library(_cached(data, sha, cache_dir))
        have = loaded_ops()
    if have["build"] != record["build"]:
        raise RuntimeError(
            f"this process has the ops of {_describe(have)}; the artifact "
            f"carries {_describe(record)}. One process holds one build of "
            "the ops: load the artifact in a fresh process")
    return have


def load_exported(path: str, cache_dir: Optional[str] = None,
                  ops_loader: Optional[Callable[[], Any]] = None,
                  sha256: Optional[str] = None
                  ) -> Tuple[torch.export.ExportedProgram, Dict[str, Any]]:
    """Load an artifact -> (ExportedProgram, meta), its ops registered
    first (`load_ops`) and the program's `.platforms` read from it; meta
    is the sidecar's, or {} without one."""
    load_ops(path, cache_dir, ops_loader, sha256)
    extra = {PLATFORMS: ""}
    exported = torch.export.load(path, extra_files=extra)
    exported.platforms = tuple(json.loads(extra[PLATFORMS]))
    meta: Dict[str, Any] = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return exported, meta


def program_module(exported: torch.export.ExportedProgram,
                   device) -> torch.nn.Module:
    """The runnable module of a loaded program on `device`, which must
    be one of its platforms (and, on a card, the loaded ops must have
    their CUDA kernels); the program is moved there if it was traced
    elsewhere."""
    dev = torch.device(device)
    if dev.type not in exported.platforms:
        raise ValueError(f"the artifact was exported for "
                         f"{list(exported.platforms)}, not {dev.type}")
    have = loaded_ops()
    if dev.type == "cuda" and not have["variant"].startswith("cuda"):
        raise RuntimeError(f"the loaded ops are {_describe(have)}, without "
                           "the CUDA kernels; the program cannot run on "
                           f"{dev}")
    traced = next(iter(exported.state_dict.values())).device
    if traced.type != dev.type:
        from torch.export.passes import move_to_device_pass
        exported = move_to_device_pass(exported, dev)
    return exported.module()


def program_inputs(exported: torch.export.ExportedProgram) -> tuple:
    """The program's (states, ev, reset, active) as the shapes and dtypes
    its placeholders carry (fake tensors)."""
    user = set(exported.graph_signature.user_inputs)
    vals = [n.meta["val"] for n in exported.graph.nodes
            if n.op == "placeholder" and n.name in user]
    args, _ = pytree.tree_unflatten(vals, exported.call_spec.in_spec)
    return args


def zero_states(exported: torch.export.ExportedProgram, device):
    """Zero state table matching the program's state inputs on
    `device`."""
    return pytree.tree_map(
        lambda v: torch.zeros(v.shape, dtype=v.dtype, device=device),
        program_inputs(exported)[0])


def run(path: str, inputs: Dict[str, Any], device="cuda",
        cache_dir: Optional[str] = None,
        sha256: Optional[str] = None) -> Dict[str, Any]:
    """Load the artifact and run the steps of `inputs` on `device` (the
    card unless the caller asks for the CPU; raises where the artifact
    was not exported for it); see the module's docstring for what it
    returns."""
    dev = torch.device(device)
    t0 = time.perf_counter()
    load_ops(path, cache_dir, sha256=sha256)
    t1 = time.perf_counter()
    exported, _ = load_exported(path, cache_dir, sha256=sha256)
    t2 = time.perf_counter()
    step = program_module(exported, dev)
    t3 = time.perf_counter()
    loads = dict(load_s=t3 - t0, load_ops_s=t1 - t0, load_program_s=t2 - t1,
                 module_s=t3 - t2)
    to = lambda t: t.to(dev)                                   # noqa: E731
    states = (pytree.tree_map(to, inputs["states"]) if "states" in inputs
              else zero_states(exported, dev))
    out: Dict[str, Any] = {"states": [], "dets": [], "valid": [],
                           "launches": [], "step_ms": []}
    for ev, reset, active in zip(inputs["ev"], inputs["reset"],
                                 inputs["active"]):
        before = launch_counts()
        start = time.perf_counter()
        states, dets, valid = step(states, to(ev), to(reset), to(active))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out["step_ms"].append((time.perf_counter() - start) * 1e3)
        after = launch_counts()
        out["launches"].append({k: after[k] - before[k] for k in after})
        cpu = lambda t: t.cpu()                                # noqa: E731
        out["states"].append(pytree.tree_map(cpu, states))
        out["dets"].append(dets.cpu())
        out["valid"].append(valid.cpu())
    out.update(loads, op_library=loaded_ops(),
               artifact_bytes=os.path.getsize(path))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Run a leod_tpu_torch serving artifact with nothing but "
                    "torch.")
    ap.add_argument("artifact")
    ap.add_argument("--inputs", required=True,
                    help="torch.save'd {'ev', 'reset', 'active'[, 'states']}")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--cache", default=None,
                    help="where the carried library is written (default: "
                         "the temp directory)")
    ap.add_argument("--sha256", default=None,
                    help="the sha256 the carried op library must have; any "
                         "other is refused before it is loaded")
    args = ap.parse_args(argv)
    inputs = torch.load(args.inputs)
    out = run(args.artifact, inputs, args.device, args.cache, args.sha256)
    out["modules"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("leod_tpu",
                                                   "leod_tpu_torch"))
    if out["modules"]:
        raise SystemExit(f"imported {out['modules']}: the artifact must run "
                         "without the packages")
    torch.save(out, args.out)
    print(json.dumps({k: out[k] for k in (
        "load_s", "load_ops_s", "load_program_s", "module_s", "step_ms",
        "op_library")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
