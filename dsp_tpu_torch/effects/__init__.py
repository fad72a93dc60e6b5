"""Effect implementations. Importing this package registers all effects.

Every effect name of dsp_tpu is registered, in the reference's order and with
the same usage strings, so the grammar, ``-h`` and allow-fail behave the
same. An effect that is not ported yet fails at init with an EffectError.
"""

from dsp_tpu_torch.effects.base import (
    EFFECT_FLAG_ALIGN_BARRIER,
    EFFECT_FLAG_CH_DEPS_IDENTITY,
    EFFECT_FLAG_NO_DITHER,
    EFFECT_FLAG_OPT_REORDERABLE,
    EFFECT_FLAG_PLOT_MIX,
    Effect,
    EffectError,
    EffectInfo,
    get_effect_info,
    print_all_effects,
    register_effect,
)

# (name, usage) of the effects still to port, in dsp_tpu's registry order
NOT_PORTED = [
    ("ladspa_host", "ladspa_host module_path plugin_label [control ...]"),
    ("watch", "watch [-e] [~/]path"),
]


def _not_ported_init(ei, istream, selector, dir_, argv):
    raise EffectError(f"{ei.name}: not yet ported to dsp_tpu_torch")


def _register_builtins():
    from dsp_tpu_torch.effects import biquad  # noqa: F401
    from dsp_tpu_torch.effects import gain  # noqa: F401
    from dsp_tpu_torch.effects import crossfeed  # noqa: F401
    from dsp_tpu_torch.effects import remix  # noqa: F401
    from dsp_tpu_torch.effects import st2ms  # noqa: F401
    from dsp_tpu_torch.effects import fir  # noqa: F401
    from dsp_tpu_torch.effects import fir_p  # noqa: F401
    from dsp_tpu_torch.effects import zita_convolver  # noqa: F401
    from dsp_tpu_torch.effects import hilbert  # noqa: F401
    from dsp_tpu_torch.effects import decorrelate  # noqa: F401
    from dsp_tpu_torch.effects import delay  # noqa: F401
    from dsp_tpu_torch.effects import noise  # noqa: F401
    from dsp_tpu_torch.effects import dither  # noqa: F401
    from dsp_tpu_torch.effects import stats  # noqa: F401
    from dsp_tpu_torch.effects import levels  # noqa: F401
    from dsp_tpu_torch.effects import resample  # noqa: F401
    from dsp_tpu_torch.effects import matrix4  # noqa: F401
    from dsp_tpu_torch.effects import matrix4_mb  # noqa: F401

    for name, usage in NOT_PORTED:
        register_effect(name, usage, _not_ported_init)


_register_builtins()

from dsp_tpu_torch.effects.base import reorder_registry as _ro  # noqa: E402

_ro()
