"""Plain references that decide ``correct``.

Written from the published algorithms (iterseg's U-Net, its affinity and
DoG watersheds, scikit-image's ``peak_local_max``, ``threshold_otsu`` and
``blob_dog``, scipy's ``gaussian_filter``) in plain PyTorch, NumPy and
SciPy. They import nothing of the program under test, and take only the
inputs the harness hands to both sides: the seeded frames and chunks and
the checkpoint's arrays.
"""
