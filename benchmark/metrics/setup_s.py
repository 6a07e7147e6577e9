"""setup_s: from the process's start to the first frame of the window: the
kernel library's load (its nvcc build on a checkout's first run), the
mesh, the program's voxelize and scene build, the warm-up frames."""


def read(run):
    return run.setup_s
