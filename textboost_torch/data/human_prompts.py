"""Fallback generic prompt bank for the knowledge-preservation loss.

A copy of textboost_tpu/data/human_prompts.py.  The reference streams human-written prompts from InstructPix2Pix's
`data/human-written-prompts.jsonl` (textboost/dataset.py:161-193), a file
the user downloads separately.  When it is absent we fall back to a
built-in bank so KPL remains usable offline.

The curated list below is ~70 prompts; with p=0.8 human-prompt sampling a
250-step bs-8 run cycles it ~23x — fine for mechanics, unrepresentative
for KPL behavior.  `EXTENDED_HUMAN_PROMPTS` therefore
augments it with a deterministic compositional bank (seeded, deduped,
>=1400 prompts) built from subject/setting/medium/atmosphere ingredient
lists over several sentence frames.  The reference jsonl stays the primary
source; `save_prompt_bank_jsonl` emits the bank in the same
{input, output} row layout for drop-in use.
"""

FALLBACK_HUMAN_PROMPTS = [
    "a photograph of a mountain lake at sunrise",
    "an oil painting of a sailing ship in a storm",
    "a city street at night in the rain",
    "a bowl of fresh fruit on a wooden table",
    "a portrait of an old fisherman with a beard",
    "children playing soccer in a park",
    "a red bicycle leaning against a brick wall",
    "a snowy forest with tall pine trees",
    "a cup of coffee next to an open book",
    "a lighthouse on a rocky coastline",
    "a field of sunflowers under a blue sky",
    "an astronaut floating above the earth",
    "a vintage car parked outside a diner",
    "a cat sleeping on a sunny windowsill",
    "a busy farmers market with colorful stalls",
    "a waterfall cascading into a clear pool",
    "a chef cooking in a restaurant kitchen",
    "a hot air balloon drifting over hills",
    "an ancient castle on a foggy hilltop",
    "a violinist performing on a dim stage",
    "a desert landscape with sand dunes at dusk",
    "a train crossing a tall stone bridge",
    "a library with shelves full of old books",
    "a surfer riding a large ocean wave",
    "a garden full of blooming roses",
    "a wooden cabin beside a frozen river",
    "a flock of birds flying over wetlands",
    "a street musician playing the guitar",
    "a plate of sushi on a black table",
    "a lightning storm over a wheat field",
    "an island with palm trees and white sand",
    "a painter working at an easel in a studio",
    "a bridge reflected in a calm river",
    "a bakery window full of fresh bread",
    "a hiker standing on a mountain summit",
    "a canal lined with colorful houses",
    "a telescope pointed at a starry sky",
    "a horse grazing in a green meadow",
    "a marketplace in an old medieval town",
    "a fox walking through autumn leaves",
    "a ferris wheel lit up at night",
    "a potter shaping clay on a wheel",
    "a rowboat tied to a wooden dock",
    "a skyline of skyscrapers at golden hour",
    "a butterfly resting on a purple flower",
    "a campfire surrounded by tents",
    "an orchestra performing in a concert hall",
    "a windmill in a field of tulips",
    "a diver swimming near a coral reef",
    "a stack of pancakes with maple syrup",
    "a cobblestone alley with hanging lanterns",
    "a polar bear on drifting sea ice",
    "a motorcycle on an empty desert highway",
    "a greenhouse full of tropical plants",
    "a clock tower above a town square",
    "a shepherd leading sheep along a ridge",
    "a pair of boots by a farmhouse door",
    "a rainbow over a coastal village",
    "a blacksmith hammering red-hot metal",
    "a kite flying high over a beach",
]


# ---------------------------------------------------------------------------
# Compositional extension (deterministic, offline)
# ---------------------------------------------------------------------------
_SUBJECTS = [
    "a golden retriever", "a tabby cat", "a red fox", "a snowy owl",
    "a hummingbird", "a sea turtle", "a herd of elephants", "a gray wolf",
    "a peacock", "a koi fish", "a brown bear", "a dragonfly",
    "an old fisherman", "a ballet dancer", "a street vendor",
    "a mountain climber", "a jazz trumpeter", "a glassblower",
    "a young astronomer", "a beekeeper", "a calligrapher", "a blacksmith",
    "a tea master", "a marathon runner", "a chess player", "a florist",
    "a vintage motorcycle", "a steam locomotive", "a wooden sailboat",
    "a red double-decker bus", "a hot air balloon", "a paraglider",
    "a tram", "a fishing trawler", "a cable car", "a biplane",
    "a bowl of ramen", "a tiered wedding cake", "a basket of peaches",
    "a cheese platter", "a pot of mulled wine", "a loaf of sourdough",
    "a plate of dumplings", "a jar of wild honey", "an espresso machine",
    "a gothic cathedral", "a timber farmhouse", "a suspension bridge",
    "a terraced rice paddy", "a desert monastery", "a clockwork tower",
    "a greenhouse full of orchids", "a subway station", "an opera house",
    "a grand piano", "a brass telescope", "an antique typewriter",
    "a stack of leather-bound books", "a spinning wheel", "a chessboard",
    "a stained-glass lamp", "a ship in a bottle", "a porcelain teapot",
    "a waterfall", "a glacier", "a volcanic crater", "a tide pool",
    "a lavender field", "a bamboo grove", "a salt flat", "a river delta",
    "an aurora", "a meteor shower", "a coral reef", "a canyon",
]
_SETTINGS = [
    "in a misty valley", "on a cobblestone street", "by a frozen lake",
    "under a starry sky", "at a bustling night market", "in an old library",
    "on a windswept cliff", "inside a greenhouse", "at the edge of a forest",
    "in a sunlit courtyard", "beneath a railway arch", "on a rooftop garden",
    "along a canal", "in a wheat field", "at an abandoned station",
    "beside a campfire", "in a snow-covered village", "on a black sand beach",
    "inside a cavern", "at a mountain pass", "in a terracotta courtyard",
    "near a lighthouse", "in the middle of a desert", "on a fishing pier",
    "under cherry blossoms", "in a flooded quarry", "at a street carnival",
    "inside an old observatory", "on a moss-covered bridge",
    "in a painter's studio",
]
_MEDIA = [
    "a photograph of", "an oil painting of", "a watercolor of",
    "a charcoal sketch of", "a woodblock print of", "a macro photo of",
    "an aerial view of", "a long-exposure shot of", "a pastel drawing of",
    "an ink illustration of", "a tilt-shift photo of", "a fresco of",
    "a linocut print of", "a silhouette of", "a double exposure of",
    "a panorama of", "an infrared photo of", "a gouache painting of",
]
_ATMOSPHERE = [
    "at golden hour", "in heavy fog", "during a thunderstorm",
    "under soft morning light", "at blue hour", "in falling snow",
    "after the rain", "in harsh midday sun", "by candlelight",
    "under neon lights", "in autumn drizzle", "at low tide",
    "during a heat haze", "in moonlight", "at first frost",
]
_FRAMES = [
    "{medium} {subject} {setting}",
    "{medium} {subject} {setting}, {atmosphere}",
    "{subject} {setting}",
    "{subject} {setting}, {atmosphere}",
    "{medium} {subject}, {atmosphere}",
    "a detailed study of {subject} {setting}",
    "a wide shot of {subject} {setting} {atmosphere}",
    "a close-up of {subject}, {atmosphere}",
]


def generate_prompt_bank(n: int = 1400, seed: int = 7):
    """Deterministic >=n unique prompts composed from the ingredient lists.

    Seeded numpy RNG + dedupe: every call reproduces the same bank, so a
    KPL run's prompt stream is stable across processes and rounds."""
    import numpy as np

    rng = np.random.default_rng(seed)
    seen = set()
    out = []
    while len(out) < n:
        frame = _FRAMES[int(rng.integers(0, len(_FRAMES)))]
        prompt = frame.format(
            medium=_MEDIA[int(rng.integers(0, len(_MEDIA)))],
            subject=_SUBJECTS[int(rng.integers(0, len(_SUBJECTS)))],
            setting=_SETTINGS[int(rng.integers(0, len(_SETTINGS)))],
            atmosphere=_ATMOSPHERE[int(rng.integers(0, len(_ATMOSPHERE)))],
        )
        if prompt not in seen:
            seen.add(prompt)
            out.append(prompt)
    return out


# Curated list first (order-stable prefix), then the compositional bank.
EXTENDED_HUMAN_PROMPTS = FALLBACK_HUMAN_PROMPTS + [
    p for p in generate_prompt_bank() if p not in set(FALLBACK_HUMAN_PROMPTS)
]


def save_prompt_bank_jsonl(path: str, prompts=None) -> None:
    """Write the bank in the reference's human-written-prompts.jsonl row
    layout ({"input": ..., "output": ...}; output "NONE" rows are skipped
    by the loader, matching rows without an edit target)."""
    import json

    with open(path, "w") as f:
        for p in prompts if prompts is not None else EXTENDED_HUMAN_PROMPTS:
            f.write(json.dumps({"input": p, "output": "NONE"}) + "\n")
