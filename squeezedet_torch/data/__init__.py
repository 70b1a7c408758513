"""Data layer: the on-device input pipeline (``device_pipeline``), the
PNG codec (``png``), the image databases and batch readers (``imdb``,
``kitti``) and the dense training targets (``targets``).

Nothing is imported here, so ``import squeezedet_torch.data.png`` loads
no model code; :func:`imdb_for_dataset` imports its dataset class.
"""


def imdb_for_dataset(dataset: str, image_set: str, data_path: str, cfg,
                     *, year: str = "2007", rng=None):
    """Dataset dispatch of the train CLI: ``dataset`` is ``KITTI``, or
    ``VOC``/``PASCAL_VOC``, which is not ported yet."""
    if dataset == "KITTI":
        from squeezedet_torch.data.kitti import Kitti
        return Kitti(image_set, data_path, cfg, rng=rng)
    if dataset in ("VOC", "PASCAL_VOC"):
        raise NotImplementedError(
            "Pascal VOC arrives with eval and the demo (ROADMAP Queue 1 "
            "item 9)")
    raise ValueError("unknown dataset {!r}: KITTI or VOC".format(dataset))
