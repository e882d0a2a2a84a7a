"""A cell, as ``BENCHMARK.json`` names it, and the data files the harness
finds by those names:

* ``BENCHMARK.json``: the cell's configuration, traffic and chips, and
  the metrics that apply to it;
* the configuration's ``file`` (``configs/<name>.json``): the model as
  it is run, in the program's ``ModelConfig`` fields, and the name of
  its plain reference under ``reference/``;
* ``traffic/<traffic>.json``: the requests (``harness/traffic.py``) and
  the deployment that serves them (engine settings, adapter pool and
  bank);
* ``checks/<cell>.json``: the numbers that decide ``correct`` and their
  limits;
* ``metrics/<metric>.py``: one reader per metric.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import typing
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "perfbench"


@dataclass
class Cell:
    root: Path
    name: str
    chips: int
    config: Dict
    traffic: Dict
    checks: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _load_json(path: Path) -> Dict:
    return json.loads(path.read_text())


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        root=root, name=name, chips=w["chips"],
        config=_load_json(root / cfg_entry["file"]),
        traffic=_load_json(root / "perfbench" / "traffic"
                           / f"{w['traffic']}.json"),
        checks=_load_json(root / "perfbench" / "checks" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def load_module(path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = ROOT) -> ModuleType:
    return load_module(root / "perfbench" / "metrics" / f"{metric}.py")


def reference(cfg: Dict, root: Path = ROOT) -> ModuleType:
    return load_module(root / "perfbench" / "reference"
                       / f"{cfg['reference']}.py")


# Keys of a configuration file that document it and are no field of the
# program's ``ModelConfig``: its provenance, its reference and its cuts.
DOC_KEYS = ("source", "paper", "reference", "reduced", "departures",
            "assumed", "notes")


def program_config(cfg: Dict):
    """The program's ``ModelConfig`` for this configuration file. Every
    key but ``DOC_KEYS`` is a field: a nested block becomes the
    sub-config its field declares (``attn``, ``lora``, ``moe``, ``ssm``,
    ...), lists become tuples, and a key that is no field raises, naming
    it, so no key the program lacks is dropped in silence. ``citation``
    is the file's ``source``."""
    from repro_torch.configs.base import ModelConfig
    kw = {k: v for k, v in cfg.items() if k not in DOC_KEYS}
    if "source" in cfg:
        kw.setdefault("citation", cfg["source"])
    return _build(ModelConfig, kw, cfg.get("name", "config"))


def _build(cls: type, values: Dict, where: str):
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(values) - fields)
    if unknown:
        raise KeyError(f"{where}: {', '.join(unknown)} is no field of the "
                       f"program's {cls.__name__} (documentation keys: "
                       f"{', '.join(DOC_KEYS)})")
    hints = typing.get_type_hints(cls)
    return cls(**{k: _value(hints[k], v, f"{where}.{k}")
                  for k, v in values.items()})


def _value(hint: Any, value: Any, where: str) -> Any:
    sub = next((t for t in (hint, *typing.get_args(hint))
                if dataclasses.is_dataclass(t)), None)
    if sub is not None and isinstance(value, dict):
        return _build(sub, value, where)
    if isinstance(value, list):
        return tuple(_value(None, v, where) for v in value)
    return value


def model_config(cfg: Dict, traffic: Dict):
    """The program's ``ModelConfig`` for this configuration, with the
    deployment's adapter pool and tenant count."""
    mc = program_config(cfg)
    lora = dataclasses.replace(mc.lora, max_resident=traffic["pool"],
                               n_adapters=traffic["requests"]["tenants"])
    return dataclasses.replace(mc, lora=lora)


def engine_config(traffic: Dict, seed: int):
    from repro_torch.serving.engine import EngineConfig
    kw = dict(traffic["engine"])
    kw["prompt_buckets"] = tuple(kw["prompt_buckets"])
    return EngineConfig(**kw, seed=seed % (2 ** 31))
