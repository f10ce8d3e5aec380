#!/bin/sh
# The canonical development run (cf. run/dev1.sh) through the PyTorch port:
# generate the restart if needed, then run one timestep of run/dev1.cfg on
# the 10x10 devgrid, writing restart.nc here.
#
# The port runs on the CUDA card; NEXTSIM_PLATFORM=cpu runs it on the CPU
# (the engine's --cpu switch). Restart files need h5py.
cd "$(dirname "$0")"
export PYTHONPATH="$(cd .. && pwd)${PYTHONPATH:+:$PYTHONPATH}"
set --
[ "${NEXTSIM_PLATFORM:-}" = cpu ] && set -- --cpu
[ -f dev1.res.nc ] || python -m nextsimdg_tpu_torch.tools.make_dev_restart dev1.res.nc
python -m nextsimdg_tpu_torch --config-file dev1.cfg "$@"
