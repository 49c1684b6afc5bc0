"""Device ms a request under the program's g.modulate spans (the style affines and demodulation factors), from the serve2 kind's spans recorded over the device stretch joined with that stretch's trace (spans.join)."""

import json

from gpubench import spans


def read(run):
    record = getattr(run, "span_record", None)
    path = getattr(run, "span_trace", None)
    if not run.trace or not record or path is None or not path.is_file():
        return None
    phase = spans.join(json.loads(path.read_text()), record)["phases"]
    return phase["g.modulate"]["device_ms"] if "g.modulate" in phase else None
