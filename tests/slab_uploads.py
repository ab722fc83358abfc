"""The feature program's input as it was made before the whole frame was
uploaded at once, for the tests that hold the two bit-equal (on the CPU
and on the card).

    from slab_uploads import slab_by_slab
"""
import numpy as np
import torch


def slab_by_slab(program):
    """An ``_upload_frame`` that makes each of ``program``'s microbatch
    slabs as the feature program once did: a pageable upload of the slab
    alone, converted on the device and divided by the volume max taken on
    the host. Slabs overlap; each voxel gets its slab's value."""
    def upload(vol, device, normalize):
        frame = torch.empty(vol.shape, dtype=torch.float32, device=device)
        denom = torch.tensor(np.max(vol.astype(np.float32)),
                             dtype=torch.float32, device=device)
        for z0, z1 in program.slab_of:
            slab = torch.from_numpy(np.ascontiguousarray(vol[z0:z1]))
            v = slab.to(device).to(torch.float32)
            frame[z0:z1] = v / denom if normalize else v
        return frame
    return upload
