"""ShapeNet synset-id <-> human category mapping.

A copy of ``hyperpocket_tpu/data/category_mapping.py`` (plain Python).
Factual ShapeNet taxonomy data; the same 57 entries the reference ships
(datasets/utils/shapenet_category_mapping.py:1-24). ``synth_id_to_number``
assigns ordinals by insertion order, as the reference does.
"""

synth_id_to_category = {
    "02691156": "airplane", "02773838": "bag", "02801938": "basket",
    "02808440": "bathtub", "02818832": "bed", "02828884": "bench",
    "02834778": "bicycle", "02843684": "birdhouse", "02871439": "bookshelf",
    "02876657": "bottle", "02880940": "bowl", "02924116": "bus",
    "02933112": "cabinet", "02747177": "can", "02942699": "camera",
    "02954340": "cap", "02958343": "car", "03001627": "chair",
    "03046257": "clock", "03207941": "dishwasher", "03211117": "monitor",
    "04379243": "table", "04401088": "telephone", "02946921": "tin_can",
    "04460130": "tower", "04468005": "train", "03085013": "keyboard",
    "03261776": "earphone", "03325088": "faucet", "03337140": "file",
    "03467517": "guitar", "03513137": "helmet", "03593526": "jar",
    "03624134": "knife", "03636649": "lamp", "03642806": "laptop",
    "03691459": "speaker", "03710193": "mailbox", "03759954": "microphone",
    "03761084": "microwave", "03790512": "motorcycle", "03797390": "mug",
    "03928116": "piano", "03938244": "pillow", "03948459": "pistol",
    "03991062": "pot", "04004475": "printer", "04074963": "remote_control",
    "04090263": "rifle", "04099429": "rocket", "04225987": "skateboard",
    "04256520": "sofa", "04330267": "stove", "04530566": "watercraft",
    "04554684": "washer", "02858304": "boat", "02992529": "cellphone",
}

category_to_synth_id = {v: k for k, v in synth_id_to_category.items()}
synth_id_to_number = {k: i for i, k in enumerate(synth_id_to_category)}


def normalize_classes(classes: list[str]) -> list[str]:
    """Map category names ('airplane') to synset ids ('02691156').

    Strict superset of the reference: its PCN-list branch silently filters to
    an empty dataset on names (datasets/shapenet.py:33-34) and its per-class
    factory KeyErrors on them (datasets/shapenet.py:104), while its
    directory-walk branch maps them (datasets/shapenet.py:39-41). Accepting
    both everywhere keeps synset-id configs bit-identical and makes name
    configs work instead of crash. Unknown entries raise ValueError (the
    reference's mapping branch raised a bare KeyError).
    """
    out = []
    for c in classes:
        if c in synth_id_to_category:
            out.append(c)
        elif c in category_to_synth_id:
            out.append(category_to_synth_id[c])
        else:
            raise ValueError(
                f"unknown dataset class {c!r}: entries of dataset.classes must "
                f"be ShapeNet synset ids (e.g. '02691156') or category names "
                f"(e.g. 'airplane'); see data/category_mapping.py for the list"
            )
    return out
