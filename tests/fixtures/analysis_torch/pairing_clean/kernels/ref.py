ORACLES = {}


def widget_double_ref(x):
    return 2.0 * x
