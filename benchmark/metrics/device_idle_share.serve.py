"""1 − the union of device operations' intervals ÷ the traced window, in
%. Moves `sr_frames_per_s`."""


def read(trace, cell):
    return trace.idle_pct()
