"""bs_roformer_custom, the declarative cover of community custom roformers
(counterpart of sesa_tpu/models/bs_roformer_custom.py).

The reference downloads and executes a ``bs_roformer.py`` named by each
entry's ``custom_model_url``; this package never executes downloaded code.
The known custom families are experimental roformers described fully by
their config: value residual learning and hyper-connections (the HyperACE
family, BS-Roformer-Large-Inst) and the FNO variant (``use_fno`` /
``fno_modes``: an FNO1d stage per depth layer, ``bs_roformer._fno_apply``).
They dispatch onto ``bs_roformer_experimental``. A config with an
architecture key outside that space raises
:class:`UnsupportedCustomArchitecture` naming it.
"""

from __future__ import annotations

from sesa_tpu_torch.models import bs_roformer_experimental as _exp


class UnsupportedCustomArchitecture(NotImplementedError):
    """A custom config uses architecture keys the declarative spec lacks."""


def _check_spec(config):
    """Build the spec alone: an unknown architecture key is the spec
    constructor's TypeError, raised here as UnsupportedCustomArchitecture.
    Errors raised inside the model itself surface unchanged."""
    try:
        _exp._spec(config)
    except TypeError as e:
        raise UnsupportedCustomArchitecture(
            "This bs_roformer_custom config is outside the declarative "
            "experimental-roformer space (value residual, hyper-connections, "
            f"FNO). Spec error: {e}. Downloaded model code is never executed; "
            "add the missing architecture option to "
            "sesa_tpu_torch/models/bs_roformer.py instead.") from e


def init(generator, config):
    _check_spec(config)
    return _exp.init(generator, config)


def apply(params, config, x, compute_dtype=None):
    _check_spec(config)
    return _exp.apply(params, config, x, compute_dtype=compute_dtype)


def convert_torch(state_dict, config):
    _check_spec(config)
    return _exp.convert_torch(state_dict, config)
