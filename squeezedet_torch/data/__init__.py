"""Data layer: the on-device input pipeline (``device_pipeline``), the
PNG codec (``png``), the image databases and batch readers (``imdb``,
``kitti``, ``pascal_voc``), the scorers (``kitti_ap``, ``voc_eval``)
and the dense training targets (``targets``).

Nothing is imported here, so ``import squeezedet_torch.data.png`` loads
no model code; :func:`imdb_for_dataset` imports its dataset class.
"""


def imdb_for_dataset(dataset: str, image_set: str, data_path: str, cfg,
                     *, year: str = "2007", rng=None):
    """Dataset dispatch shared by the train/eval CLIs: ``dataset`` is
    ``KITTI`` or ``VOC``/``PASCAL_VOC`` (the CLI-flag spellings)."""
    if dataset == "KITTI":
        from squeezedet_torch.data.kitti import Kitti
        return Kitti(image_set, data_path, cfg, rng=rng)
    if dataset in ("VOC", "PASCAL_VOC"):
        from squeezedet_torch.data.pascal_voc import PascalVoc
        return PascalVoc(image_set, year, data_path, cfg, rng=rng)
    raise ValueError("unknown dataset {!r}: KITTI or VOC".format(dataset))
