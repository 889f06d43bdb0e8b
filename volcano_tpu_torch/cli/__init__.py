"""vtctl — the port's control CLI (a copy of ``volcano_tpu/cli``, for the
commands whose callers the port has): ``python -m
volcano_tpu_torch.cli.vtctl``."""


def main(argv=None, api=None, out=None) -> int:
    """``cli.vtctl.main``, imported when called, so that running the
    module with ``-m`` does not find it imported already."""
    from volcano_tpu_torch.cli.vtctl import main as vtctl_main

    return vtctl_main(argv, api=api, out=out)


__all__ = ["main"]
