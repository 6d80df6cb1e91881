import ctypes

from repro_torch.kernels import build

_DOUBLE = build.Entry("widget", "widget_double_f32",
                      (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float))
_SCALE = build.Entry("widget", "widget_scale_f32",
                     (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                      ctypes.c_int64, ctypes.c_int))
_MISSING = build.Entry("widget", "widget_missing_f32", (ctypes.c_void_p,))


def widget_scale(acc, x, w):
    _SCALE.launch(acc.get_device(), acc.data_ptr(), x.data_ptr(), float(w),
                  acc.numel())


def widget_scale_into(acc, x, w):
    fresh = torch.empty_like(x)
    _SCALE.launch(acc.get_device(), acc.data_ptr(), fresh.data_ptr(),
                  float(w), acc.numel(), 0)
