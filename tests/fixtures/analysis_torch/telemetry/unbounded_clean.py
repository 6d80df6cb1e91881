class Series:
    def __init__(self, sketch):
        self.sketch = sketch
        self.spans = []

    def observe(self, key, value):
        self.sketch.add(key, value)
        self.spans.append((key, value))
