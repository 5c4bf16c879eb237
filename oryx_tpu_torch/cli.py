"""Operational CLI (the port's copy of the ``batch``, ``speed`` and
``serving`` subcommands of oryx_tpu/cli.py):

  python -m oryx_tpu_torch.cli batch --app als --conf oryx.conf
  python -m oryx_tpu_torch.cli speed --app als --conf oryx.conf
  python -m oryx_tpu_torch.cli serving --app als --conf oryx.conf

(``--app kmeans`` and ``--app rdf`` as well; their input schema comes from
the config, ``oryx.input-schema.*``)

runs that layer on the CUDA card until interrupted (each raises without a
card). ``--set key=value`` overrides a config key (repeatable); ``--app
<name>`` overlays the packaged app's classes and serving resources
(apps/spi.py) underneath any explicit ``--set``. The JAX package's other
subcommands, its pod mode and its serving replica supervisor
(``oryx.serving.api.processes > 1``) are not ported yet (``ServingLayer``
raises on the latter, the batch layer on a pod config).
"""

from __future__ import annotations

import argparse
import json
import logging
import signal
import sys

from oryx_tpu_torch.common.config import Config, load_config


def _parse_args(argv):
    p = argparse.ArgumentParser(prog="oryx_tpu_torch", description=__doc__)
    p.add_argument("command", choices=["batch", "speed", "serving"])
    p.add_argument(
        "--app", default=None, metavar="NAME",
        help="packaged app to run (registry lookup, apps/spi.py): als, "
        "kmeans or rdf. "
        "Overlays the app's classes and serving resources underneath any "
        "explicit --set",
    )
    p.add_argument("--conf", help="user config file (HOCON-like key paths)")
    p.add_argument(
        "--set",
        action="append",
        default=[],
        metavar="KEY=VALUE",
        help="config override, repeatable (e.g. --set oryx.serving.api.port=8080)",
    )
    return p.parse_args(argv)


def _build_config(args) -> Config:
    overlay = {}
    for kv in args.set:
        if "=" not in kv:
            raise SystemExit(f"--set needs KEY=VALUE, got: {kv}")
        k, v = kv.split("=", 1)
        try:
            overlay[k] = json.loads(v)
        except json.JSONDecodeError:
            overlay[k] = v
    return load_config(args.conf, overlay=overlay)


def _run_until_interrupt(layer) -> int:
    stop = signal.getsignal(signal.SIGTERM)
    signal.signal(signal.SIGTERM, lambda *_: layer.close())
    try:
        layer.start()
        layer.await_termination()
    except KeyboardInterrupt:
        pass
    finally:
        layer.close()
        signal.signal(signal.SIGTERM, stop)
    return 0


def cmd_batch(config: Config) -> int:
    from oryx_tpu_torch.layers import BatchLayer

    return _run_until_interrupt(BatchLayer(config))


def cmd_speed(config: Config) -> int:
    from oryx_tpu_torch.layers import SpeedLayer

    return _run_until_interrupt(SpeedLayer(config))


def cmd_serving(config: Config) -> int:
    from oryx_tpu_torch.serving.server import ServingLayer

    return _run_until_interrupt(ServingLayer(config))


def main(argv=None) -> int:
    args = _parse_args(argv if argv is not None else sys.argv[1:])
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    if args.app is not None:
        # PREPEND the app's class/resource wiring so any explicit --set
        # still wins
        from oryx_tpu_torch.apps.spi import app_overlay

        try:
            overlay = app_overlay(args.app)
        except ValueError as e:
            raise SystemExit(str(e))
        args.set[:0] = [f"{k}={json.dumps(v)}" for k, v in overlay.items()]
    config = _build_config(args)
    cmd = {"batch": cmd_batch, "speed": cmd_speed, "serving": cmd_serving}
    return cmd[args.command](config)


if __name__ == "__main__":
    sys.exit(main())
