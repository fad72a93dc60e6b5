"""Plot mode: emit a gnuplot program for the chain's transfer function
(reference: effects_chain.c:1105-1184), the text of dsp_tpu's
chain/plot.py byte for byte. It computes no audio and touches no device."""

from dsp_tpu_torch.effects.base import EFFECT_FLAG_PLOT_MIX

_HEADER = """set xlabel 'Frequency (Hz)'
set ylabel 'Magnitude (dB)'
set logscale x
set samples 500
set mxtics
set mytics
set grid xtics ytics mxtics mytics lw 0.8, lw 0.3
set key on
j={0,1}

set yrange [-30:20]
"""

_HEADER_PHASE = """set ytics nomirror
set y2tics -180,90,180 format '%g°'
set y2range [-180:720]
"""


class PlotError(Exception):
    pass


def plot_chain(chain, plot_phase=False):
    """Return the gnuplot program as a string."""
    fs = chain.istream.fs
    # build each effect's lines ONCE, at its real index (the support probe
    # and the emission used to call plot() twice — expensive for effects
    # whose plot expression is large)
    plots = [e.plot(i) for i, e in enumerate(chain.effects)]
    for e, p in zip(chain.effects, plots):
        if p is None:  # NULL e->plot (effects_chain.c:1130-1133)
            raise PlotError(
                f"plot: error: effect '{e.name}' does not support plotting"
            )
        if e.istream.channels != e.ostream.channels and not (e.flags & EFFECT_FLAG_PLOT_MIX):
            raise PlotError(
                f"plot: BUG: effect '{e.name}' changed the number of channels "
                "but does not have EFFECT_FLAG_PLOT_MIX set!"
            )
        fs = e.ostream.fs
    lines = [_HEADER + f"set xrange [10:{fs}/2]\n" + (_HEADER_PHASE if plot_phase else "")]
    channels = chain.istream.channels
    start_idx = 0
    effects = chain.effects
    for i, e in enumerate(effects):
        if e.flags & EFFECT_FLAG_PLOT_MIX:
            for k in range(e.istream.channels):
                comp = f"Ht{k}_{i}(f)=1.0"
                for j in range(start_idx, i):
                    comp += f"*H{k}_{j}(2.0*pi*f/{effects[j].ostream.fs})"
                lines.append(comp)
            start_idx = i
            channels = e.ostream.channels
        lines.extend(plots[i])
    for k in range(channels):
        comp = f"Ht{k}(f)=1.0"
        for j in range(start_idx, len(effects)):
            comp += f"*H{k}_{j}(2.0*pi*f/{effects[j].ostream.fs})"
        lines.append(comp)
        lines.append(f"Ht{k}_mag(f)=abs(Ht{k}(f))")
        lines.append(f"Ht{k}_mag_dB(f)=20*log10(Ht{k}_mag(f))")
        lines.append(f"Ht{k}_phase(f)=arg(Ht{k}(f))")
        lines.append(f"Ht{k}_phase_deg(f)=Ht{k}_phase(f)*180/pi")
        lines.append(f"Hsum{k}(f)=Ht{k}_mag_dB(f)")
    plot_parts = []
    for k in range(channels):
        plot_parts.append(f"Ht{k}_mag_dB(x) lt {k + 1} lw 2 title 'Channel {k}'")
        if plot_phase:
            plot_parts.append(f"Ht{k}_phase_deg(x) axes x1y2 lt {k + 1} lw 1 dt '-' notitle")
    lines.append("\nplot " + ", ".join(plot_parts))
    lines.append("pause mouse close")
    return "\n".join(lines) + "\n"
