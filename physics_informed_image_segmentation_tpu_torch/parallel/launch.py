"""Start N ranks of a module on this host, joined through a file store.

    python -m physics_informed_image_segmentation_tpu_torch.parallel.launch N MODULE [ARGS...]

Runs ``python -m MODULE ARGS --init-method file://DIR/store`` N times with
``RANK``, ``LOCAL_RANK`` and ``WORLD_SIZE`` set (the module passes the URL
to :func:`.mesh.initialize_distributed`, as ``megapixel`` and
``spatial_check`` do); rank r takes GPU r.  Unlike torchrun it opens no
port and looks up no host name, and NCCL's and gloo's own sockets are kept
on the loopback interface (``NCCL_SOCKET_IFNAME``, ``GLOO_SOCKET_IFNAME``
``=lo`` unless set): for hosts where a program must reach nothing else.
Each rank's output is printed after the run, prefixed by its rank; if a
rank fails, the others are killed, and the exit code is the first non-zero
one.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

__all__ = ["main"]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    n, module, args = int(argv[0]), argv[1], argv[2:]
    base = {"NCCL_SOCKET_IFNAME": "lo", "GLOO_SOCKET_IFNAME": "lo", **os.environ}
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(n)]
        procs = [
            subprocess.Popen(
                [sys.executable, "-m", module, *args, "--init-method", f"file://{tmp}/store"],
                env=dict(base, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(n)),
                stdout=logs[r], stderr=subprocess.STDOUT)
            for r in range(n)
        ]
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.1)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for r, log in enumerate(logs):
            log.seek(0)
            for line in log:
                print(f"[rank {r}] {line}", end="")
            log.close()
    codes = [p.returncode for p in procs]
    return next((c for c in codes if c != 0), 0)


if __name__ == "__main__":
    sys.exit(main())
