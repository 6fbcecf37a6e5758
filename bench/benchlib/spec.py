"""What a run measures, found by name: the cell in ``BENCHMARK.json``, its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``) and its own settings and limits
(``workloads/<cell>.json``), all under the benchmark's directory."""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # configs/<config>.json
    traffic: dict         # traffic/<traffic>.json
    settings: dict        # workloads/<cell>.json
    bench: dict           # BENCHMARK.json

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    def end_to_end(self) -> list[dict]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> list[dict]:
        """The per-layer metrics this cell reports: those that list it, and
        those that list no cells and move an end-to-end metric it reports."""
        mine = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in mine)]


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load(workload: str, root: Path = ROOT) -> Cell:
    bench = _read(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    w = cells[workload]
    here = root / "bench"
    return Cell(name=workload, chips=int(w["chips"]),
                config=_read(here / "configs" / f"{w['config']}.json"),
                traffic=_read(here / "traffic" / f"{w['traffic']}.json"),
                settings=_read(here / "workloads" / f"{workload}.json"),
                bench=bench)


def program_config(config: dict):
    """The program's ModelConfig for a configuration file: the registry's
    entry with the file's overrides, the fused deployment where the file
    asks for it, held key by key to the file's ``model`` section."""
    from repro_torch.configs import common, registry
    prog = config["program"]
    cfg = registry.get(prog["registry"], smoke=prog.get("smoke", False),
                       **prog.get("overrides", {}))
    if prog.get("fused"):
        cfg = common.fused_of(cfg)
    model = config["model"]
    for key, want in model.items():
        if key == "activation":
            got = {k: getattr(cfg.activation, k) for k in want}
        else:
            got = getattr(cfg, key)
        if got != want:
            raise SystemExit(f"{config['name']}: the program runs {key}="
                             f"{got!r}, the configuration file says {want!r}")
    return cfg
