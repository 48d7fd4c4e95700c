"""Model and Settings scaffolding (port of smc_tpu/settings.py, host Python):
a `GenericModel` holding parameters and a settings dict, the translation of
the reference package's canonical setting names into `smc()` kwargs, and
vintage-stamped output paths. `smc()` itself never reads Settings."""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Dict, List, Optional

from smc_tpu_torch.params import Parameter, ParamSpace

DATE_FORMAT = "%y%m%d"


@dataclasses.dataclass
class Setting:
    key: str
    value: Any
    print_flag: bool = False
    code: str = ""
    description: str = ""


class GenericModel:
    """Parameters plus settings: `model.add(...)` (or `model <= ...`) takes
    a Parameter or a Setting; settings read dict-style."""

    def __init__(self, spec: str = "generic", subspec: str = "ss0"):
        self.spec = spec
        self.subspec = subspec
        self.parameters: List[Parameter] = []
        self.settings: Dict[str, Setting] = {}
        self.set("dataroot", "data")
        self.set("saveroot", "save")
        self.set("data_vintage",
                 datetime.date.today().strftime(DATE_FORMAT))

    def add(self, obj) -> "GenericModel":
        if isinstance(obj, Parameter):
            self.parameters.append(obj)
        elif isinstance(obj, Setting):
            self.settings[obj.key] = obj
        else:
            raise TypeError(f"cannot add {type(obj)} to GenericModel")
        return self

    def __le__(self, obj):
        return self.add(obj)

    def set(self, key: str, value) -> None:
        self.settings[key] = Setting(key, value)

    def get(self, key: str, default=None):
        s = self.settings.get(key)
        return s.value if s is not None else default

    def __getitem__(self, key: str):
        return self.settings[key].value

    def param_space(self, regime_switching: bool = False) -> ParamSpace:
        return ParamSpace(self.parameters, regime_switching=regime_switching)


# the reference package's canonical SMC setting names -> smc() kwargs
_SETTING_TO_KWARG = {
    "n_particles": "n_parts",
    "n_smc_blocks": "n_blocks",
    "n_mh_steps_smc": "n_mh_steps",
    "lambda": "lam",
    "n_phi": "n_phi",
    "resampler_smc": "resampling_method",
    "step_size_smc": "c",
    "target_accept": "target",
    "mixture_proportion": "alpha",
    "tempering_target": "tempering_target",
    "resampling_threshold": "threshold_ratio",
    "use_fixed_schedule": "use_fixed_schedule",
    "tempered_update_prior_weight": "tempered_update_prior_weight",
}


def smc_settings_kwargs(model: GenericModel) -> Dict[str, Any]:
    """A model's SMC-related Settings as `smc()` kwargs."""
    return {kwarg: model.settings[name].value
            for name, kwarg in _SETTING_TO_KWARG.items()
            if name in model.settings}


def rawpath(model: GenericModel, subdir: str, filename: str,
            filestring_addl: Optional[List[str]] = None) -> str:
    """<saveroot>/output_data/<spec>/<subspec>/<subdir>/raw/
    <name>_vint=<vintage>[_addl].<ext>."""
    root = os.path.join(str(model.get("saveroot", "save")), "output_data",
                        model.spec, model.subspec, subdir, "raw")
    base, ext = os.path.splitext(filename)
    tags = [f"vint={model.get('data_vintage')}"]
    if filestring_addl:
        tags.extend(filestring_addl)
    return os.path.join(root, base + "_" + "_".join(tags) + ext)


def dataroot(model: GenericModel) -> str:
    return str(model.get("dataroot", "data"))
