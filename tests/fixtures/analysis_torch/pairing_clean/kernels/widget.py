import ctypes

from repro_torch.kernels import build

_DOUBLE = build.Entry("widget", "widget_double_f32",
                      (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64))


def widget_double(x):
    out = x.new_empty(x.numel())
    _DOUBLE.launch(x.get_device(), x.data_ptr(), out.data_ptr(), x.numel())
    return out
