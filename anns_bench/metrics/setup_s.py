"""setup_s: seconds from the start of the run to the start of the window:
data made on the card, the build, the deployment, the kernel library's
load (and first build), and the warm-up of every batch size."""


def read(run):
    return run.setup_s
