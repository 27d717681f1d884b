"""Top-level alias: `python -m recon3d_tpu_torch.serve` == runtime/serve.py.

The persistent reconstruction service lives in
recon3d_tpu_torch.runtime.serve; this shim gives it the short invocation
the docs use."""

from recon3d_tpu_torch.runtime.serve import (  # noqa: F401
    DEFAULT_SOCKET,
    ReconstructionServer,
    ensure_server,
    main,
    ping,
    probe,
    request,
    shutdown,
)

if __name__ == "__main__":
    import sys

    sys.exit(main())
