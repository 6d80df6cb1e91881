import ctypes

from repro_torch.kernels import build

_DOUBLE = build.Entry("widget", "widget_double_f32",
                      (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64))
_SCALE = build.Entry("widget", "widget_scale_f32",
                     (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                      ctypes.c_int64, ctypes.c_int))


def _launch(index, x, out, n):
    _DOUBLE.launch(index, x.data_ptr(), out.data_ptr(), n)


def widget_double(x):
    out = x.new_empty(x.numel())
    _launch(x.get_device(), x, out, x.numel())
    return out


def aio_absorb(acc, den, x, m, w):
    scalars = (float(w), acc.numel(), 0)
    _SCALE.launch(acc.get_device(), acc.data_ptr(), x.data_ptr(), *scalars)
