class Series:
    def __init__(self):
        self.by_label = {}

    def observe(self, key, value, cells):
        self.by_label.setdefault(key, []).append(value)
        cells[key].append(value)
        self.by_label.get(key, []).append(value)
