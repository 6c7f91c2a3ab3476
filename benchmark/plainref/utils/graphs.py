"""The reference runs every program op by op: `run` calls the body eagerly
on the call's device, where the port replays a captured CUDA graph."""

from __future__ import annotations


def run(name, body, inputs, static, device, mesh=None):
    if mesh is not None:
        raise ValueError("the reference runs on one device")
    return body(*(None if x is None else x.to(device) for x in inputs))
