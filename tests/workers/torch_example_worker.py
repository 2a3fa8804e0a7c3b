"""Run one of ``examples/torch/*.py`` on gloo ranks of the CPU.

``spawn(example, world, argv, tmp, params=None)`` starts ``world`` processes
of this file; each joins a ``file://`` store, calls the example's
``run(args, params)`` with ``argv`` parsed by the example's own parser
(``--device cpu`` added) and writes the JSON-able part of its result.
``params`` is a flax param tree of numpy arrays (the JAX example's init),
handed to every rank.  ``launch(example, nproc, argv, tmp)`` runs the
example as a user does, under the port's launcher (``bagua-tpu-torch-run``),
and returns its exit code and output.  ``load(example)`` imports an example
by path for an in-process call.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
EXAMPLES = os.path.join(REPO, "examples", "torch")


def load(example: str):
    """The module ``examples/torch/<example>.py``."""
    path = os.path.join(EXAMPLES, f"{example}.py")
    spec = importlib.util.spec_from_file_location(f"torch_example_{example}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _nested(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def jsonable(result: dict) -> dict:
    """The entries of an example's result that JSON can hold."""
    out = {}
    for k, v in result.items():
        try:
            json.dumps(v)
        except (TypeError, ValueError):
            continue
        out[k] = v
    return out


def spawn(example, world, argv, tmp, params=None, timeout=300, env=None):
    """Every rank's JSON result of ``example`` at ``world`` gloo ranks."""
    params_path = ""
    if params is not None:
        params_path = str(tmp / f"{example}_params.npz")
        np.savez(params_path, **_flat(params))
    store = tmp / f"{example}_store"
    outs = [tmp / f"{example}_rank{r}.json" for r in range(world)]
    full_env = {**os.environ, "OMP_NUM_THREADS": "1", **(env or {}),
                "PYTHONPATH": os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), example, str(r), str(world),
         f"file://{store}", params_path, str(outs[r]), json.dumps(list(argv))],
        env=full_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    codes = [p.returncode for p in procs]
    assert codes == [0] * world, (codes, [log[-3000:] for log in logs])
    results = []
    for path, log in zip(outs, logs):
        with open(path) as f:
            rec = json.load(f)
        rec["stdout"] = log
        results.append(rec)
    return results


def launch(example, nproc, argv, tmp, flags=(), env=None, timeout=300):
    """``python -m bagua_tpu_torch.distributed.run --nproc_per_node nproc
    [flags] examples/torch/<example>.py argv --device cpu``: the exit code
    and the launcher's and every rank's output."""
    from bagua_tpu_torch.utils import find_free_port

    full_env = {k: v for k, v in os.environ.items() if not k.startswith("BAGUA_TEST_")}
    full_env.update(OMP_NUM_THREADS="1", **(env or {}),
                    PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    cmd = [sys.executable, "-m", "bagua_tpu_torch.distributed.run", "--monitor_interval", "0.2",
           "--nproc_per_node", str(nproc), "--master_port", str(find_free_port()), *flags,
           os.path.join(EXAMPLES, f"{example}.py"), *argv, "--device", "cpu"]
    out = subprocess.run(cmd, cwd=str(tmp), env=full_env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, timeout=timeout)
    return out.returncode, out.stdout


def main(example, rank, world, init_method, params_path, out_path, argv):
    import torch

    import bagua_tpu_torch as bt

    torch.set_num_threads(1)
    bt.init_process_group(init_method, world_size=int(world), rank=int(rank), device="cpu")
    module = load(example)
    args = module.parser().parse_args([*json.loads(argv), "--device", "cpu"])
    params = _nested(dict(np.load(params_path))) if params_path else None
    result = module.run(args, params)
    with open(out_path, "w") as f:
        json.dump(jsonable(result), f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
