"""Canonical VidVRD / VidOR vocabularies (public dataset constants; a copy
of tspn_tpu/data/vocab.py, held equal by tests/test_torch_detector_train.py).

Index = position in lexicographic order, which is what the annotation
layer's sorted-vocab construction produces on the full datasets. Used by
the detection stage's class heads.
"""

VIDVRD_OBJECTS = [
    "airplane", "antelope", "ball", "bear", "bicycle",
    "bird", "bus", "car", "cattle", "dog",
    "domestic_cat", "elephant", "fox", "frisbee", "giant_panda",
    "hamster", "horse", "lion", "lizard", "monkey",
    "motorcycle", "person", "rabbit", "red_panda", "sheep",
    "skateboard", "snake", "sofa", "squirrel", "tiger",
    "train", "turtle", "watercraft", "whale", "zebra",
]

VIDVRD_PREDICATES = [
    "above", "away", "behind", "beneath", "bite", "chase",
    "creep_above", "creep_away", "creep_behind", "creep_beneath",
    "creep_front", "creep_left", "creep_next_to", "creep_past",
    "creep_right", "creep_toward", "drive", "fall_off", "faster",
    "feed", "fight", "fly_above", "fly_away", "fly_behind", "fly_front",
    "fly_left", "fly_next_to", "fly_past", "fly_right", "fly_toward",
    "fly_with", "follow", "front", "hold", "jump_above", "jump_away",
    "jump_behind", "jump_beneath", "jump_front", "jump_left",
    "jump_next_to", "jump_past", "jump_right", "jump_toward",
    "jump_with", "kick", "larger", "left", "lie_above", "lie_behind",
    "lie_beneath", "lie_front", "lie_inside", "lie_left", "lie_next_to",
    "lie_right", "lie_with", "move_above", "move_away", "move_behind",
    "move_beneath", "move_front", "move_left", "move_next_to",
    "move_past", "move_right", "move_toward", "move_with", "next_to",
    "past", "play", "pull", "ride", "right", "run_above", "run_away",
    "run_behind", "run_beneath", "run_front", "run_left", "run_next_to",
    "run_past", "run_right", "run_toward", "run_with", "sit_above",
    "sit_behind", "sit_beneath", "sit_front", "sit_inside", "sit_left",
    "sit_next_to", "sit_right", "stand_above", "stand_behind",
    "stand_beneath", "stand_front", "stand_inside", "stand_left",
    "stand_next_to", "stand_right", "stand_with", "stop_above",
    "stop_behind", "stop_beneath", "stop_front", "stop_left",
    "stop_next_to", "stop_right", "stop_with", "swim_behind",
    "swim_beneath", "swim_front", "swim_left", "swim_next_to",
    "swim_right", "swim_with", "taller", "touch", "toward",
    "walk_above", "walk_away", "walk_behind", "walk_beneath",
    "walk_front", "walk_left", "walk_next_to", "walk_past",
    "walk_right", "walk_toward", "walk_with", "watch",
]

VIDOR_OBJECTS = [
    "adult", "aircraft", "antelope", "baby", "baby_seat", "baby_walker",
    "backpack", "ball/sports_ball", "bat", "bear", "bench", "bicycle",
    "bird", "bottle", "bread", "bus/truck", "cake", "camel", "camera",
    "car", "cat", "cattle/cow", "cellphone", "chair", "chicken",
    "child", "crab", "crocodile", "cup", "dish", "dog", "duck",
    "electric_fan", "elephant", "faucet", "fish", "frisbee", "fruits",
    "guitar", "hamster/rat", "handbag", "horse", "kangaroo", "laptop",
    "leopard", "lion", "microwave", "motorcycle", "oven", "panda",
    "penguin", "piano", "pig", "rabbit", "racket", "refrigerator",
    "scooter", "screen/monitor", "sheep/goat", "sink", "skateboard",
    "ski", "snake", "snowboard", "sofa", "squirrel", "stingray",
    "stool", "stop_sign", "suitcase", "surfboard", "table", "tiger",
    "toilet", "toy", "traffic_light", "train", "turtle", "vegetables",
    "watercraft",
]

VIDOR_PREDICATES = [
    "above", "away", "behind", "beneath", "bite", "caress", "carry",
    "chase", "clean", "close", "cut", "drive", "feed", "get_off",
    "get_on", "grab", "hit", "hold", "hold_hand_of", "hug",
    "in_front_of", "inside", "kick", "kiss", "knock", "lean_on",
    "lick", "lift", "next_to", "open", "pat", "play(instrument)",
    "point_to", "press", "pull", "push", "release", "ride",
    "shake_hand_with", "shout_at", "smell", "speak_to", "squeeze",
    "throw", "touch", "towards", "use", "watch", "wave", "wave_hand_to",
]
