"""The device's idle share of the traced stretch: no kernel and no copy
running, in percent — ``device_idle.train``'s reader, loaded by name."""

from pathlib import Path

from perfbench import spec

read = spec.reader(Path(__file__).resolve().parents[2], "device_idle.train")
