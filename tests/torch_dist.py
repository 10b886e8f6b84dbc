"""The port's side of the multi-process CPU tests: ``world`` gloo processes.

`run` spawns ``world`` processes (`torch.multiprocessing`), each a rank of
one gloo process group, hands each the same payload (numpy arrays and plain
values, pickled), runs one worker function of this module in every rank,
and returns the ranks' results. The ranks meet through a file store in the
spawn's own temporary directory, not at a TCP port: a port number picked
free and released before rank 0 binds it (seconds later, under a loaded
test run) can be taken meanwhile by another process, such as the sockets of
another test module's gloo ranks, and a group then meets foreign peers. This module imports torch,
numpy and the port only, never JAX or the JAX package; every rank reports
whether either was loaded in it (``"jax_loaded"``), and `run` raises if so.
The test modules compute the JAX side in the pytest process and spawn once
a module, every case in that one spawn.
"""

import os
import pickle
import socket
import sys
import tempfile

import numpy as np
import torch
import torch.multiprocessing as mp


def _free_port() -> int:
    """A TCP port free at the time of the call (for a test that needs one)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(world: int, worker: str, payload) -> list:
    """[result of ``worker(rank, world, payload)`` for each rank]."""
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "in.pkl"), "wb") as f:
            pickle.dump(payload, f)
        mp.spawn(_entry, args=(world, d, worker), nprocs=world, join=True)
        out = []
        for r in range(world):
            with open(os.path.join(d, f"out{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    for r, res in enumerate(out):
        if res["jax_loaded"]:
            raise AssertionError(f"rank {r} loaded {res['jax_loaded']}")
    return [res["result"] for res in out]


def _entry(rank: int, world: int, d: str, worker: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(d, 'store')}",
                            rank=rank, world_size=world)
    try:
        with open(os.path.join(d, "in.pkl"), "rb") as f:
            payload = pickle.load(f)
        result = globals()[worker](rank, world, payload)
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "fastforward_tpu"))
        with open(os.path.join(d, f"out{rank}.pkl"), "wb") as f:
            pickle.dump({"result": result, "jax_loaded": loaded}, f)
    finally:
        dist.destroy_process_group()


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy() if t.is_floating_point() else t.detach().numpy()


_MESHES = {}


def _mesh(axes: dict):
    from fastforward_tpu_torch.parallel import make_mesh

    key = tuple(axes.items())
    if key not in _MESHES:
        _MESHES[key] = make_mesh(dict(axes), device_type="cpu")
    return _MESHES[key]


def _config(kw: dict):
    from fastforward_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(**kw, dtype=torch.float32)


# --- workers ---------------------------------------------------------------


def moe_ep(rank, world, payload):
    """Each case: `expert_parallel_moe` over an ``expert`` mesh of every rank."""
    from fastforward_tpu_torch.serving.convert import moe_block_from_flat
    from fastforward_tpu_torch.serving.moe import expert_parallel_moe

    mesh = _mesh({"expert": world})
    out = []
    for case in payload:
        block = moe_block_from_flat(case["flat"], device="cpu")
        y = expert_parallel_moe(mesh, block, torch.from_numpy(case["x"]))
        out.append(_np(y))
    return out


def _stacked_from_flat(flat):
    from fastforward_tpu_torch.serving.convert import params_from_flat

    return params_from_flat(flat, device="cpu")


def _slab(kw, batch, max_len):
    from fastforward_tpu_torch.serving.stacked import StackedKVCache

    return StackedKVCache.create(kw["num_layers"], batch, max_len, kw["num_kv_heads"],
                                 kw["head_dim"], quantized=True, device="cpu")


def _paged(case):
    from fastforward_tpu_torch.serving.paged import PagedKVCache

    a = case["pool"]
    return PagedKVCache(*(torch.from_numpy(np.array(a[k])) for k in
                          ("k", "v", "k_scale", "v_scale", "table")), length=case["length"])


def tp(rank, world, payload):
    """TP cases (`parallel/tp_serving.py`) on the meshes they name."""
    from fastforward_tpu_torch.parallel import tp_serving as tps
    from fastforward_tpu_torch.serving.sampling import SamplingParams

    out = []
    for case in payload:
        mesh = _mesh(case["axes"])
        kw, kind = case["config"], case["kind"]
        config = _config(kw)
        data_axis = case.get("data_axis", "data")
        params, stacked = _stacked_from_flat(case["flat"])
        if kind == "reject":
            try:
                tps.make_tp_decode_step(config, mesh, stacked, params, None)
                out.append(None)
            except ValueError as e:
                out.append(str(e))
            continue
        cache = _paged(case) if "pool" in case else _slab(kw, case["batch"], case["max_len"])
        p, s, c = tps.shard_for_tp(params, stacked, cache, mesh, data_axis, config=config)
        rows = case["rows"][mesh.get_local_rank(data_axis)]
        token = torch.from_numpy(case["tokens"][rows[0]:rows[1]]).long()
        if kind == "step":
            step = tps.make_tp_decode_step(config, mesh, stacked, params, cache, data_axis)
            logits = []
            for i in range(case["steps"]):
                lg, c = step(p, s, c, token, torch.tensor([case.get("positions0", 0) + i]))
                logits.append(_np(lg))
                token = torch.argmax(lg[:, -1], dim=-1)[:, None]
            out.append({"logits": logits, "tokens": np.stack([np.argmax(l[:, -1], -1)
                                                             for l in logits], 1)})
            continue
        sampling = None
        if case.get("sampling"):
            sampling = SamplingParams(**case["sampling"])
        loop = tps.make_tp_decode_loop(config, mesh, stacked, params, cache, case["steps"],
                                       data_axis, sampling=sampling)
        if sampling is None:
            toks, c = loop(p, s, c, token)
        else:
            toks, c = loop(p, s, c, token, torch.Generator().manual_seed(case["seed"]))
        out.append({"tokens": toks.numpy(), "length": c.length})
    return out


def sharded(rank, world, payload):
    """Per-layer GSPMD-equivalent cases (`parallel/sharding.py`)."""
    from fastforward_tpu_torch.parallel import sharding as sh
    from fastforward_tpu_torch.serving.convert import params_from_flat
    from fastforward_tpu_torch.serving.kv_cache import KVCache

    out = []
    for case in payload:
        mesh = _mesh(case["axes"])
        kw = case["config"]
        config = _config(kw)
        params, _ = params_from_flat(case["flat"], device="cpu")
        try:
            local = sh.shard_serving_params(params, mesh)
        except ValueError as e:
            out.append({"error": str(e)})
            continue
        ids = torch.from_numpy(case["ids"]).long()
        cache = None
        if case.get("cache"):
            B, S = case["cache"]
            cache = sh.shard_kv_cache(KVCache.create(kw["num_layers"], B, S, kw["num_kv_heads"],
                                                     kw["head_dim"], quantized=True,
                                                     device="cpu"), mesh)
        logits, cache = sh.sharded_serving_forward(local, config, ids, mesh, cache)
        res = {"logits": _np(logits), "q_shape": tuple(local.layers[0].q_proj.data.shape),
               "o_shape": tuple(local.layers[0].o_proj.data.shape)}
        if cache is not None:
            res["length"] = cache.length
            res["k_shape"] = tuple(cache.layers[0].k.shape)
        out.append(res)
    return out


def multihost(rank, world, payload):
    """The hybrid mesh at 2 hosts x 2, its batch slice and a TP step with
    the batch over ``dcn``."""
    from fastforward_tpu_torch.parallel import host_local_batch_slice, make_hybrid_mesh

    mesh = make_hybrid_mesh({"model": -1}, num_hosts=2, device_type="cpu")
    res = {"names": mesh.mesh_dim_names, "shape": tuple(mesh.shape),
           "coord": (mesh.get_local_rank("dcn"), mesh.get_local_rank("model")),
           "slice": host_local_batch_slice(8, mesh)}
    try:
        host_local_batch_slice(7, mesh)
    except ValueError as e:
        res["slice_error"] = str(e)
    try:
        make_hybrid_mesh({"model": 3}, num_hosts=2, device_type="cpu")
    except ValueError as e:
        res["axes_error"] = str(e)
    _MESHES[(("dcn", 2), ("model", 2))] = mesh
    res["tp"] = tp(rank, world, payload)
    return res


def context_pipeline(rank, world, payload):
    """Ring attention (`parallel/context.py`), the GPipe pipeline
    (`parallel/pipeline.py`) with its errors, and the dry run
    (`parallel/dryrun.py`)."""
    from fastforward_tpu_torch.parallel import (
        context_parallel_attention,
        dryrun_multichip,
        pipeline_forward,
    )
    from fastforward_tpu_torch.serving.engine import QuantLinear

    res = {"ring": [], "pipeline": [], "errors": {}}
    for case in payload["ring"]:
        mesh = _mesh(case["axes"])
        dtype = getattr(torch, case["dtype"])
        q, k, v = (torch.from_numpy(case[n]).to(dtype) for n in "qkv")
        res["ring"].append(_np(context_parallel_attention(mesh, q, k, v, "sp",
                                                          causal=case["causal"])))

    def stacked(a):
        return QuantLinear(data=torch.from_numpy(a["data"]), scale=torch.from_numpy(a["scale"]),
                           mode="w4a8_2l", group_size=a["group_size"],
                           mult=torch.from_numpy(a["mult"]), paired=a["paired"])

    def layer_fn(ql, h):
        return ql(h, out_dtype=torch.float32)

    layers = stacked(payload["layers"])
    x = torch.from_numpy(payload["x"])
    h = x
    for i in range(layers.data.shape[0]):  # the sequential loop, one process
        h = layer_fn(QuantLinear(layers.data[i], layers.scale[i], "w4a8_2l",
                                 layers.group_size, layers.mult[i], layers.paired), h)
    res["sequential"] = _np(h)
    for case in payload["pipeline"]:
        mesh = _mesh(case["axes"])
        res["pipeline"].append(_np(pipeline_forward(mesh, layers, x, layer_fn,
                                                    n_microbatches=case["microbatches"])))
    mesh = _mesh({"rep": world // 2, "stage": 2})
    for name, call in (
            ("batch", lambda: pipeline_forward(mesh, layers, x[:5], layer_fn, n_microbatches=2)),
            ("layers", lambda: pipeline_forward(mesh, QuantLinear(
                layers.data[:3], layers.scale[:3], "w4a8_2l", layers.group_size,
                layers.mult[:3], layers.paired), x, layer_fn, n_microbatches=2)),
            ("ring", lambda: context_parallel_attention(
                _mesh({"sp": world}), *(torch.zeros(1, 2, 6, 8) for _ in range(3))))):
        try:
            call()
        except ValueError as e:
            res["errors"][name] = str(e)
    res["dryrun"] = dryrun_multichip("cpu")
    return res


def parallel_cuda(rank, world, payload):
    """Ring attention and the pipeline with every rank on cuda:0 (gloo:
    the hops cross host memory); run by the card-only tests."""
    from fastforward_tpu_torch.kernels import launch_counts, reset_launch_counts
    from fastforward_tpu_torch.parallel import (
        context_parallel_attention,
        make_mesh,
        pipeline_forward,
    )
    from fastforward_tpu_torch.serving.engine import QuantLinear

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    q, k, v = (torch.from_numpy(payload[n]).to(dev, torch.bfloat16) for n in "qkv")
    ring = context_parallel_attention(make_mesh({"sp": world}), q, k, v, "sp")
    a = payload["layers"]
    layers = QuantLinear(data=torch.from_numpy(a["data"]).to(dev),
                         scale=torch.from_numpy(a["scale"]).to(dev), mode="w4a8_2l",
                         group_size=a["group_size"], mult=torch.from_numpy(a["mult"]).to(dev),
                         paired=a["paired"])
    reset_launch_counts()
    x = torch.from_numpy(payload["x"]).to(dev)
    y = pipeline_forward(make_mesh({"stage": world}), layers, x,
                         lambda ql, h: ql(h, out_dtype=torch.float32),
                         n_microbatches=payload["microbatches"])
    torch.cuda.synchronize()
    return {"ring": _np(ring.cpu()), "pipeline": _np(y.cpu()), "counts": dict(launch_counts)}


def qat(rank, world, payload):
    """The dry run's QAT step (`parallel/dryrun.py` `qat_model`, `qat_step`)
    from the JAX model's parameters: on a group of this rank alone over the
    whole batch, then on the world over this rank's rows; the loss and every
    parameter after each step."""
    import torch.distributed as dist

    from fastforward_tpu_torch.nn.convert import load_nnx_params
    from fastforward_tpu_torch.parallel.dryrun import qat_model, qat_step

    alone = [dist.new_group([r]) for r in range(world)][rank]
    out = {}
    for size, group in ((1, alone), (world, dist.group.WORLD)):
        model = qat_model("cpu")
        load_nnx_params(model, payload["params"])
        rows = payload["x"].shape[0] // size
        part = slice(rank % size * rows, (rank % size + 1) * rows)
        loss = qat_step(model, torch.from_numpy(payload["x"][part]),
                        torch.from_numpy(payload["y"][part]), group=group)
        out[size] = {"loss": loss, "params": {n: _np(p) for n, p in model.named_parameters()}}
    return out
