"""1 − the union of device operations' intervals ÷ the traced window, in
%. Moves `train_images_per_s`."""


def read(trace, cell):
    return trace.idle_pct()
